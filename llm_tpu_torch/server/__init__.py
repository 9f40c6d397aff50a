"""The OpenAI-compatible server: the slot engine (core.py) and its HTTP
layer on the standard library (app.py)."""
