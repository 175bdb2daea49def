"""Serving of the port: samplers and the batched generation engine."""
