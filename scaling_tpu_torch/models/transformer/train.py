"""Transformer training entry (counterpart of
scaling_tpu/models/transformer/train.py): config -> context -> model ->
optimizer -> datasets -> trainer, with tokens/s, the four TFLOPs
estimators and PaLM MFU riding on the trainer's metric hook, the
trainer's telemetry told the model's FLOPs per token (and, on the card,
the H100's peak, so that each step record carries ``mfu``), and the
config's ``profiler`` section.

``main(config, device=None)`` trains on the card unless ``device="cpu"``;
``python -m scaling_tpu_torch.train run <config.yml>`` is its command line.
Under the supervisor (``scaling_tpu_torch.runner``) the environment
names a control plane, which the trainer joins with the preemption
handler installed. With ``image_encoder_clip_checkpoint`` the pretrained
CLIP trunk is spliced in after the load, on a fresh run only
(``apply_pretrained_clip``). ``python -m scaling_tpu_torch.models.transformer.train
--payload=<base64 config>`` is the worker a runner launches
(``worker_main``): it joins the launch's process group and trains on
``cuda:(LOCAL_SLOT % device_count)``. A config of several ranks
(``topology`` with ``data_parallel_size``, ``model_parallel_size`` or
``pipe_parallel_size`` above 1) builds this rank's ``Topology``, its
shards and its pipe stage's layers; the SIGTERM handler
is then installed on every rank, which agree on a preemption at each
step boundary.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from ... import resolve_device
from ...data.blended_dataset import BlendedDatasetConfig
from ...determined import DeterminedGlue
from ...logging import logger
from ...profiler import Profiler
from ...resilience import controlplane_from_env
from ...runner import LaunchConfig, initialize_distributed
from ...topology import Topology
from ...topology.topology import rank_device
from ...trainer import BaseTrainer
from .config import TransformerConfig
from .context import TransformerContext
from .data import (
    FinetuningChatBlendedDataset,
    FinetuningChatDataset,
    FinetuningTextBlendedDataset,
    FinetuningTextDataset,
    TextBlendedDataset,
    TextDataset,
)
from .model import init_model, init_optimizer, loss_function
from .utils.get_tflops import (
    H100_BF16_TFLOPS,
    get_flops_per_token,
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
    """One dataset a prefix, blended when there are several: the finetuning
    datasets (``data.finetuning_dataset`` / ``finetuning_chat_dataset``,
    which need ``transformer_architecture.vocab_file``) or token streams."""
    if not prefixes:
        return None
    arch, data, seed = config.transformer_architecture, config.data, config.trainer.seed
    softprompt = arch.softprompt_config.n_tokens if arch.softprompt_config else 0
    if data.finetuning_dataset or data.finetuning_chat_dataset:
        if arch.vocab_file is None:
            raise ValueError("finetuning datasets need transformer_architecture.vocab_file")
        if data.finetuning_chat_dataset:
            datasets: List[Any] = [
                FinetuningChatDataset(data_prefix=p, sequence_length=arch.sequence_length,
                                      vocab_file=arch.vocab_file, seed=seed,
                                      softprompt_n_tokens=softprompt)
                for p in prefixes]
            blended_cls: Any = FinetuningChatBlendedDataset
        else:
            datasets = [
                FinetuningTextDataset(data_prefix=p, sequence_length=arch.sequence_length,
                                      vocab_file=arch.vocab_file, seed=seed,
                                      memory_map_dataset=data.finetuning_dataset_memory_map,
                                      softprompt_n_tokens=softprompt)
                for p in prefixes]
            blended_cls = FinetuningTextBlendedDataset
    else:
        datasets = [
            TextDataset(data_prefix=p, sequence_length=arch.sequence_length, seed=seed,
                        eod_token_id=data.eod_token_id,
                        only_full_sequences=data.only_full_sequences,
                        allow_incomplete_sequences_every_n=data.allow_incomplete_sequences_every_n,
                        load_index_to_memory=data.load_mmap_index_to_memory,
                        legacy_dataset=data.legacy_dataset)
            for p in prefixes]
        blended_cls = TextBlendedDataset
    if len(datasets) == 1:
        return datasets[0]
    return blended_cls(seed=seed, config=data.blended_dataset or BlendedDatasetConfig(),
                       datasets=datasets)


class TransformerTrainer(BaseTrainer):
    def run_training(self, log_metrics_fn=None) -> None:
        """``BaseTrainer.run_training`` with this module's ``log_metrics_fn``
        unless the caller passes another (``run_with_resume`` passes None)."""
        super().run_training(log_metrics_fn=log_metrics_fn or globals()["log_metrics_fn"])


def build_trainer(config: TransformerConfig, device=None,
                  glue: Optional[DeterminedGlue] = None) -> TransformerTrainer:
    """The trainer of ``config``, initialised: the model from
    ``trainer.seed`` or, with ``trainer.load_dir``, from its checkpoint, and
    the loaders at the context's consumed samples. With a Determined
    ``glue`` (``DeterminedGlue.detect()``) the trainer reports to it, and
    the experiment's latest checkpoint wins over ``load_dir``."""
    device = resolve_device(device)
    layout = (Topology(config.topology, device=device) if config.topology.world_size > 1
              else None)
    logger.configure(config.logger, name="transformer")
    if layout is not None:
        logger.set_rank(layout.global_rank)
        logger.info(f"layout: {layout.describe()}")
    logger.info(f"config: {config.to_dict()}")
    module = init_model(config, device=device, topology=layout)
    trainer = TransformerTrainer(
        config=config.trainer,
        context=TransformerContext(config=config, topology=config.topology),
        parallel_module=module,
        optimizer=init_optimizer(config, module.model, module),
        loss_function=loss_function,
        dataset=_read_dataset(config, config.data.data_prefixes),
        dataset_evaluation=_read_dataset(config, config.data.validation_data_prefixes),
        batch_to_model_input=batch_to_model_input,
        profiler=Profiler(config.profiler),
    )
    arch, topo = config.transformer_architecture, config.topology
    param_count = get_model_parameter_count(arch.hidden_size, arch.num_layers, arch.vocab_size,
                                            arch.mlp_factor, glu=arch.mlp_type == "swiglu")
    # the peak is the card's, declared on the card only: a CPU run records
    # no mfu, as it records no palm_mfu
    trainer.telemetry.configure(
        flops_per_token=get_flops_per_token(param_count, arch.num_layers, arch.hidden_size,
                                            arch.sequence_length),
        tokens_per_step=topo.global_batch_size * arch.sequence_length,
        world_size=topo.world_size,
        peak_tflops=H100_BF16_TFLOPS if device.type == "cuda" else None)
    # under the supervisor: heartbeats (or a healthy worker reads as hung
    # after the startup grace), the coordinated drain, the commit barrier
    cp = controlplane_from_env()
    if cp is not None:
        trainer.attach_control_plane(cp, shared_save_dir=config.trainer.multihost_shared_save_dir)
    if cp is not None or layout is not None:
        trainer.install_preemption_handler()
    if glue is None:
        trainer.initialize(load_checkpoint=config.trainer.load_dir is not None)
    else:
        glue.attach(trainer)
        with glue.latest_checkpoint() as det_ckpt:
            trainer.initialize(
                load_checkpoint=det_ckpt is not None or config.trainer.load_dir is not None,
                load_dir=det_ckpt)
    clip_checkpoint = arch.image_encoder_clip_checkpoint
    if clip_checkpoint is not None:
        apply_pretrained_clip(trainer, clip_checkpoint)
    return trainer


def read_clip_checkpoint(path) -> Dict[str, torch.Tensor]:
    """The state dict of pretrained CLIP vision weights: a file
    ``torch.load`` reads (a ``state_dict`` entry is unwrapped), or a
    directory holding ``pytorch_model.bin``. The port reads them without
    ``transformers``, so any other form raises ValueError."""
    p = Path(path)
    if p.is_dir():
        if not (p / "pytorch_model.bin").is_file():
            raise ValueError(f"image_encoder_clip_checkpoint {p}: a directory needs a "
                             "pytorch_model.bin (the port reads no safetensors or other "
                             "transformers formats); pass a torch.load file instead")
        p = p / "pytorch_model.bin"
    sd = torch.load(p, map_location="cpu", weights_only=True)
    return sd.get("state_dict", sd)


def apply_pretrained_clip(trainer: BaseTrainer, path) -> None:
    """Splice pretrained CLIP weights into the image encoder's trunk at
    train start, as the JAX trainer's ``_apply_pretrained_clip``: not on a
    resume (``iterations > 0``) nor after a load that restored the trunk;
    on a fresh run or a finetune from a checkpoint without it. The trunk's
    f32 masters are taken from the spliced weights and its moments zeroed,
    so that the first step does not revert it; the moments the load gave
    the rest of the model are kept."""
    if trainer.context.iterations > 0:
        logger.info(f"resume at step {trainer.context.iterations}: skipping the pretrained "
                    "CLIP splice (the trunk is in the checkpoint)")
        return
    if any("image_encoder.clip." in k for k in trainer.restored_model_keys):
        logger.info("the loaded checkpoint restored the CLIP trunk; skipping the pretrained "
                    "CLIP splice")
        return
    encoder = trainer.module.model.embedding.image_encoder
    if encoder is None:
        raise ValueError("image_encoder_clip_checkpoint set but the model has no image encoder "
                         "(set image_encoder: true, image_encoder_backbone: clip)")
    encoder.load_clip_weights(read_clip_checkpoint(path))
    opt = trainer.optimizer
    if trainer.optimizer_states_loaded:
        with torch.no_grad():
            for name in opt.optimized:
                if ".image_encoder.clip." in name:
                    opt.state.master[name].copy_(opt.params[name])
                    opt.state.exp_avg[name].zero_()
                    opt.state.exp_avg_sq[name].zero_()
    else:
        opt.state = opt.init_state()
    logger.info(f"loaded pretrained CLIP vision weights from {path}")


def main(config: TransformerConfig, device=None) -> TransformerTrainer:
    """Train as ``config`` says; returns the trainer after its last step.
    Inside a Determined task (the SDK importable and its cluster info
    present) the run reports to Determined through ``DeterminedGlue``."""
    glue = DeterminedGlue.detect()
    try:
        trainer = build_trainer(config, device, glue=glue)
        trainer.run_training()
    finally:
        if glue is not None:
            glue.close()
    return trainer


def worker_main(argv: Optional[List[str]] = None, device=None) -> TransformerTrainer:
    """The worker of a runner: the config from ``--payload``, trained by
    ``main`` on ``device``, by default the card of the launch's slot."""
    launch = LaunchConfig.from_launcher_args(argv)
    if launch.payload is None:
        raise ValueError("--payload is required")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = rank_device("cuda", launch.local_slot)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    initialize_distributed(launch, device_type=dev.type)
    return main(TransformerConfig.from_dict(launch.payload), device=dev)


if __name__ == "__main__":
    worker_main()
