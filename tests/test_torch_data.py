"""The port's token datasets and loader against the JAX package's.

The same documents, drawn with numpy from a seed, go through both
packages' builders, readers, ``TextDataset`` packing, blended index and
``DataLoader``; everything must be equal, byte for byte or element for
element (no arithmetic differs: these are index computations).
"""

import hashlib
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from scaling_tpu.data.blended_dataset import BlendedDatasetConfig as JaxBlendedConfig  # noqa: E402
from scaling_tpu.data.dataloader import DataLoader as JaxDataLoader  # noqa: E402
from scaling_tpu.data.memory_map import MemoryMapDataset as JaxMemoryMap  # noqa: E402
from scaling_tpu.data.memory_map import MemoryMapDatasetBuilder as JaxBuilder  # noqa: E402
from scaling_tpu.models.transformer.data.text_dataset import (  # noqa: E402
    TextBlendedDataset as JaxTextBlended,
)
from scaling_tpu.models.transformer.data.text_dataset import TextDataset as JaxTextDataset  # noqa: E402
from scaling_tpu.topology import Topology, TopologyConfig  # noqa: E402
from scaling_tpu_torch.data import (  # noqa: E402
    BlendedDatasetConfig,
    DataLoader,
    MemoryMapDataset,
    MemoryMapDatasetBuilder,
)
from scaling_tpu_torch.models.transformer.data import (  # noqa: E402
    TextBlendedDataset,
    TextDataset,
)

SEQ = 32
FIELDS = ("token_ids", "target_token_ids", "position_ids", "segment_ids", "loss_weights")


def documents(seed, n, low=4, high=90, vocab=96):
    """``n`` documents of random length, each ending in EOD 0."""
    rng = np.random.default_rng(seed)
    return [np.append(rng.integers(1, vocab, size=rng.integers(low, high)), 0) for _ in range(n)]


def build(builder_cls, prefix, docs, dtype=np.uint16):
    with builder_cls(prefix, dtype=dtype) as b:
        for d in docs:
            b.add(d)
    return prefix


@pytest.fixture(scope="module")
def prefixes(tmp_path_factory):
    """Two datasets written by the port's builder and one by the JAX one."""
    root = tmp_path_factory.mktemp("data")
    return {
        "a": build(MemoryMapDatasetBuilder, root / "a", documents(0, 20)),
        "b": build(MemoryMapDatasetBuilder, root / "b", documents(1, 12, high=140)),
        "jax": build(JaxBuilder, root / "jax", documents(2, 30)),
    }


def digest(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


@pytest.mark.parametrize("dtype", [np.uint16, np.int32])
def test_builders_write_the_same_bytes(tmp_path, dtype):
    docs = documents(3, 17)
    port = build(MemoryMapDatasetBuilder, tmp_path / "port", docs, dtype)
    ref = build(JaxBuilder, tmp_path / "jax", docs, dtype)
    for suffix in (".bin", ".idx", ".meta.json"):
        assert digest(Path(str(port) + suffix)) == digest(Path(str(ref) + suffix)), suffix


@pytest.mark.parametrize("which", ["a", "jax"])
def test_readers_read_each_others_files(prefixes, which):
    port, ref = MemoryMapDataset(prefixes[which]), JaxMemoryMap(prefixes[which])
    assert len(port) == len(ref) and port.dtype == ref.dtype
    np.testing.assert_array_equal(port.sizes(), ref.sizes())
    for i in range(len(ref)):
        np.testing.assert_array_equal(port[i], ref[i])
    np.testing.assert_array_equal(port.read_span(5, 300), ref.read_span(5, 300))


PACKING = {
    "plain": {},
    "only_full_sequences": {"only_full_sequences": True},
    "every_3": {"only_full_sequences": True, "allow_incomplete_sequences_every_n": 3},
}


@pytest.mark.parametrize("packing", list(PACKING))
@pytest.mark.parametrize("which", ["b", "jax"])
def test_text_dataset_spans_and_items_equal_jax(prefixes, packing, which):
    kw = PACKING[packing]
    port = TextDataset(prefixes[which], SEQ, seed=3, **kw)
    ref = JaxTextDataset(prefixes[which], SEQ, seed=3, **kw)
    assert len(port) == len(ref) > 0
    if kw:
        np.testing.assert_array_equal(port._item_starts, ref._item_starts)
        np.testing.assert_array_equal(port._item_ends, ref._item_ends)
    for i in range(len(ref)):
        np.testing.assert_array_equal(port[i].token_ids, ref[i].token_ids)
    items = list(range(min(len(ref), 6)))
    got = port.collate([port[i] for i in items])
    want = ref.collate([ref[i] for i in items])
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert port.ident() == ref.ident()


def jax_topology(mbs):
    return Topology(TopologyConfig(model_parallel_size=1, pipe_parallel_size=1,
                                   data_parallel_size=1, micro_batch_size=mbs,
                                   gradient_accumulation_steps=1))


def loader_pair(dataset_port, dataset_ref, consumed, mbs=4, seed=5):
    return (DataLoader(seed=seed, consumed_samples=consumed, dataset=dataset_port,
                       micro_batch_size=mbs),
            JaxDataLoader(seed=seed, consumed_samples=consumed, dataset=dataset_ref,
                          topology=jax_topology(mbs)))


def blended_port(prefixes, cache=None):
    kw = {} if cache is None else {"cache_directory": cache}
    return TextBlendedDataset(seed=5, config=BlendedDatasetConfig(**kw),
                              datasets=[TextDataset(prefixes[k], SEQ, seed=5) for k in "ab"])


def blended_jax(prefixes, cache=None):
    kw = {} if cache is None else {"cache_directory": cache}
    return JaxTextBlended(seed=5, config=JaxBlendedConfig(**kw),
                          datasets=[JaxTextDataset(prefixes[k], SEQ, seed=5) for k in "ab"])


def blended(prefixes):
    return blended_port(prefixes), blended_jax(prefixes)


@pytest.mark.parametrize("consumed", [0, 8])
def test_loader_batches_equal_jax_across_an_epoch_and_after_resume(prefixes, consumed):
    """20 micro-batches of 4 cross the end of the first epoch of the
    blended dataset (a new seed, so a new blend order), from the start and
    resumed at ``consumed_samples`` 8."""
    port_ds, ref_ds = blended(prefixes)
    epoch = len(ref_ds) // 4 * 4
    assert consumed + 20 * 4 > epoch, "the batches must cross an epoch boundary"
    port, ref = loader_pair(port_ds, ref_ds, consumed)
    for i in range(20):
        got, want = next(port), next(ref)
        for field in FIELDS:
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field),
                                          err_msg=f"batch {i} {field}")
        assert port.consumed_samples == ref.consumed_samples == consumed + 4 * (i + 1)


def test_resumed_loader_continues_the_stream(prefixes):
    """A loader resumed at ``consumed_samples`` 8 gives the batches a fresh
    loader gives from its third on."""
    port_ds, _ = blended(prefixes)
    fresh = DataLoader(seed=5, consumed_samples=0, dataset=port_ds, micro_batch_size=4)
    stream = [next(fresh) for _ in range(12)][2:]
    resumed = DataLoader(seed=5, consumed_samples=8, dataset=port_ds, micro_batch_size=4)
    for want in stream:
        got = next(resumed)
        np.testing.assert_array_equal(got.token_ids, want.token_ids)


def test_blended_index_and_its_cache_equal_jax(prefixes, tmp_path):
    """Each package caches its index in its own directory: the same files,
    the index bytes equal; then each reads the other's cache."""
    port = blended_port(prefixes, cache=tmp_path / "port")
    ref = blended_jax(prefixes, cache=tmp_path / "jax")
    np.testing.assert_array_equal(port.dataset_indices, ref.dataset_indices)
    np.testing.assert_array_equal(port.weights, ref.weights)
    assert port.ident() == ref.ident()
    port_files = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert port_files == sorted(p.name for p in (tmp_path / "jax").iterdir()) and port_files
    for name in port_files:
        if name.endswith(".bin"):
            assert digest(tmp_path / "port" / name) == digest(tmp_path / "jax" / name)
    np.testing.assert_array_equal(blended_port(prefixes, cache=tmp_path / "jax").dataset_indices,
                                  ref.dataset_indices)
    np.testing.assert_array_equal(blended_jax(prefixes, cache=tmp_path / "port").dataset_indices,
                                  port.dataset_indices)


def test_batch_goes_to_the_device_as_the_model_takes_it(prefixes):
    """``as_model_input`` gives int64 token ids, int32 positions and
    segments and f32 loss weights, equal to the host arrays, for a stacked
    (gas, mbs, s) batch too."""
    import torch

    ds = TextDataset(prefixes["b"], SEQ, seed=0)
    batches = [ds.collate([ds[i], ds[i + 1]]) for i in (0, 2, 4)]
    stacked = type(batches[0]).stack(batches)
    out = stacked.as_model_input("cpu")
    assert out["token_ids"].dtype == torch.int64 and out["token_ids"].shape == (3, 2, SEQ)
    assert out["position_ids"].dtype == torch.int32
    assert out["loss_weights"].dtype == torch.float32
    for field in FIELDS:
        np.testing.assert_array_equal(out[field].numpy(), getattr(stacked, field), err_msg=field)


def test_legacy_dataset_is_not_ported(prefixes):
    with pytest.raises(NotImplementedError, match="legacy"):
        TextDataset(prefixes["a"], SEQ, legacy_dataset=True)
