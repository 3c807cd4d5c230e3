"""Experimental subsystems (reference: python/ray/experimental/; own copy of
ray_tpu.experimental)."""
