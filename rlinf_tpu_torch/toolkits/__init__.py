"""Command-line toolkits of the port (``ckpt_convert``)."""
