"""Parameter count, training FLOPs per token and PaLM MFU (the port's copy
of the functions it needs from scaling_tpu/models/transformer/utils/get_tflops.py).

The peak is the card's: an H100 SXM's dense bf16 rate, 989.4 TFLOP/s, the
figure the JAX package's ``HardwareType.H100`` carries.
"""

from __future__ import annotations

H100_BF16_TFLOPS = 989.4


def get_model_parameter_count(hidden_size: int, num_layers: int, vocab_size: int,
                              mlp_factor: float = 4.0, glu: bool = False) -> int:
    per_layer = 4 * hidden_size * hidden_size + (3 if glu else 2) * int(
        hidden_size * hidden_size * mlp_factor)
    return num_layers * per_layer + vocab_size * hidden_size


def get_flops_per_token(parameter_count: int, num_layers: int, hidden_size: int,
                        sequence_length: int) -> float:
    """PaLM appendix B: ``6 N`` for the matmuls plus ``12 L H S`` for attention."""
    return 6.0 * parameter_count + 12.0 * num_layers * hidden_size * sequence_length


def get_palm_mfu(parameter_count: int, num_layers: int, hidden_size: int,
                 sequence_length: int, tokens_per_second: float, world_size: int = 1,
                 peak_tflops: float = H100_BF16_TFLOPS) -> float:
    """Observed tokens/s over the token rate the peak FLOP rate allows."""
    flops_per_token = get_flops_per_token(parameter_count, num_layers, hidden_size,
                                          sequence_length)
    return tokens_per_second / (peak_tflops * 1e12 * world_size / flops_per_token)
