"""Models of the port (counterpart of scaling_tpu/models/)."""
