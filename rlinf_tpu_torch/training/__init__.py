"""Training of the port: train state, optimizer, policy train step and
logprob recompute (``rlinf_tpu/training``)."""
