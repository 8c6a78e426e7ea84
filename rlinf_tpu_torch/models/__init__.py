"""Models of the port: the dense decoder LLM."""
