"""Serving stack of the port (after ``paddle_tpu.inference``)."""
