"""Transformer training entry (counterpart of
scaling_tpu/models/transformer/train.py): config -> context -> model ->
optimizer -> datasets -> trainer, with tokens/s, the four TFLOPs
estimators and PaLM MFU riding on the trainer's metric hook.

``main(config, device=None)`` trains on the card unless ``device="cpu"``;
``python -m scaling_tpu_torch.train run <config.yml>`` is its command line.
"""

from __future__ import annotations

from typing import Any, List, Optional

from ... import resolve_device
from ...data.blended_dataset import BlendedDatasetConfig
from ...logging import Logger
from ...trainer import BaseTrainer
from .config import TransformerConfig
from .context import TransformerContext
from .data.text_dataset import TextBlendedDataset, TextDataset
from .model import init_model, init_optimizer, loss_function
from .utils.get_tflops import (
    get_model_parameter_count,
    get_palm_mfu,
    get_tflops_aleph_alpha,
    get_tflops_bloom,
    get_tflops_electra,
    get_tflops_megatron,
)


def batch_to_model_input(batch, device) -> dict:
    return batch.as_model_input(device)


def log_metrics_fn(trainer: BaseTrainer, output, metrics: dict) -> dict:
    """Adds tokens/s, the four TFLOPs estimators and, on the card, PaLM MFU
    against the H100's 989.4 TFLOP/s bf16 peak (a rate of the card's peak
    is not taken from a CPU run)."""
    config: TransformerConfig = trainer.context.config
    arch = config.transformer_architecture
    topo = config.topology
    step_time = output.step_duration or 1e-9
    gbs, seq = topo.global_batch_size, arch.sequence_length
    param_count = get_model_parameter_count(arch.hidden_size, arch.num_layers, arch.vocab_size,
                                            arch.mlp_factor, glu=arch.mlp_type == "swiglu")
    metrics["tokens_per_second"] = gbs * seq / step_time
    metrics["tflops_megatron"] = get_tflops_megatron(param_count, step_time, gbs, seq)
    metrics["tflops_bloom"] = get_tflops_bloom(
        arch.hidden_size, arch.num_layers, arch.vocab_size, step_time, gbs, seq,
        activation_checkpointing=topo.activation_checkpointing_type != "disabled")
    metrics["tflops_electra"] = get_tflops_electra(
        arch.hidden_size, arch.num_layers, arch.num_attention_heads, arch.vocab_size, seq,
        step_time, gbs, arch.mlp_factor)
    metrics["tflops_aleph_alpha"] = get_tflops_aleph_alpha(
        arch.hidden_size, arch.num_layers, arch.num_attention_heads, arch.vocab_size, seq,
        step_time, gbs, arch.mlp_factor)
    if trainer.device.type == "cuda":
        metrics["palm_mfu"] = get_palm_mfu(param_count, arch.num_layers, arch.hidden_size, seq,
                                           metrics["tokens_per_second"])
    return metrics


def _read_dataset(config: TransformerConfig, prefixes: Optional[List[Any]]):
    """One TextDataset a prefix, blended when there are several."""
    if not prefixes:
        return None
    data = config.data
    datasets = [
        TextDataset(data_prefix=p, sequence_length=config.transformer_architecture.sequence_length,
                    seed=config.trainer.seed, eod_token_id=data.eod_token_id,
                    only_full_sequences=data.only_full_sequences,
                    allow_incomplete_sequences_every_n=data.allow_incomplete_sequences_every_n,
                    load_index_to_memory=data.load_mmap_index_to_memory)
        for p in prefixes
    ]
    if len(datasets) == 1:
        return datasets[0]
    return TextBlendedDataset(seed=config.trainer.seed,
                              config=data.blended_dataset or BlendedDatasetConfig(),
                              datasets=datasets)


class TransformerTrainer(BaseTrainer):
    def run_training(self, log_metrics_fn=log_metrics_fn) -> None:  # noqa: D102
        super().run_training(log_metrics_fn=log_metrics_fn)


def build_trainer(config: TransformerConfig, device=None) -> TransformerTrainer:
    """The trainer of ``config``, initialised: the model from
    ``trainer.seed`` or, with ``trainer.load_dir``, from its checkpoint, and
    the loaders at the context's consumed samples."""
    device = resolve_device(device)
    logger = Logger(config.logger, name="transformer")
    logger.info(f"config: {config.to_dict()}")
    module = init_model(config, device=device)
    trainer = TransformerTrainer(
        config=config.trainer,
        context=TransformerContext(config=config, topology=config.topology),
        parallel_module=module,
        optimizer=init_optimizer(config, module.model),
        loss_function=loss_function,
        logger=logger,
        dataset=_read_dataset(config, config.data.data_prefixes),
        dataset_evaluation=_read_dataset(config, config.data.validation_data_prefixes),
        batch_to_model_input=batch_to_model_input,
    )
    trainer.initialize(load_checkpoint=config.trainer.load_dir is not None)
    return trainer


def main(config: TransformerConfig, device=None) -> TransformerTrainer:
    """Train as ``config`` says; returns the trainer after its last step."""
    trainer = build_trainer(config, device)
    trainer.run_training()
    return trainer
