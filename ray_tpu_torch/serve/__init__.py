"""Serving: the LLM engine (serve/llm.py). The serve control plane of the
JAX package is ported in a later slice."""
