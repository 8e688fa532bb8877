"""The training benchmark of the port (``python -m scaling_tpu_torch.train bench``)."""
