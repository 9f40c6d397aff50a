"""Parallel execution: the mixture-of-experts dispatch (moe.py). The
expert-parallel mesh of the JAX package's parallel/ waits for the port's
meshes (ROADMAP Queue 1 item 10)."""
