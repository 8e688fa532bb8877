"""Parameter count, the TFLOPs estimators and PaLM MFU (the port's copy of
scaling_tpu/models/transformer/utils/get_tflops.py).

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


def get_tflops_megatron(parameter_count: int, iter_time_s: float, global_batch_size: int,
                        sequence_length: int) -> float:
    """6 * N * tokens."""
    return 6.0 * parameter_count * global_batch_size * sequence_length / iter_time_s / 1e12


def get_tflops_bloom(hidden_size: int, num_layers: int, vocab_size: int, iter_time_s: float,
                     global_batch_size: int, sequence_length: int,
                     activation_checkpointing: bool = False) -> float:
    """The Megatron paper's appendix formula, 4/3 with recompute."""
    coeff = 4.0 if activation_checkpointing else 3.0
    flops = (24.0 * coeff * global_batch_size * sequence_length * num_layers * hidden_size ** 2
             * (1.0 + sequence_length / (6.0 * hidden_size)
                + vocab_size / (16.0 * num_layers * hidden_size)))
    return flops / iter_time_s / 1e12


def get_tflops_electra(hidden_size: int, num_layers: int, num_attention_heads: int,
                       vocab_size: int, sequence_length: int, iter_time_s: float,
                       global_batch_size: int, mlp_factor: float = 4.0) -> float:
    """The forward's operations counted per op, x3 for forward and backward."""
    head_dim = hidden_size // num_attention_heads
    attn = (3 * 2 * hidden_size * hidden_size
            + 2 * num_attention_heads * sequence_length * head_dim
            + 2 * num_attention_heads * sequence_length * head_dim
            + 2 * hidden_size * hidden_size)
    mlp = 2 * 2 * int(hidden_size * hidden_size * mlp_factor)
    per_token = num_layers * (attn + mlp) + 2 * hidden_size * vocab_size
    return 3.0 * per_token * global_batch_size * sequence_length / iter_time_s / 1e12


def get_tflops_aleph_alpha(hidden_size: int, num_layers: int, num_attention_heads: int,
                           vocab_size: int, sequence_length: int, iter_time_s: float,
                           global_batch_size: int, mlp_factor: float = 4.0) -> float:
    """The house estimator with the attention's quadratic term."""
    qkv = 6 * hidden_size * hidden_size
    scores = 2 * sequence_length * hidden_size
    ctx = 2 * sequence_length * hidden_size
    dense = 2 * hidden_size * hidden_size
    mlp = 4 * int(hidden_size * hidden_size * mlp_factor)
    per_token = num_layers * (qkv + scores + ctx + dense + mlp) + 2 * hidden_size * vocab_size
    return 3.0 * per_token * global_batch_size * sequence_length / iter_time_s / 1e12


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
