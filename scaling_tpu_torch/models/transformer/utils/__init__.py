"""Utilities of the transformer (counterpart of scaling_tpu/models/transformer/utils/)."""
