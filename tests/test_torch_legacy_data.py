"""Megatron-format data in the port against the JAX package.

Documents drawn with numpy from a seed are written in both Megatron
layouts: MMIDIDX by either package's ``LegacyMMapIndexWriter`` (the two
write the same bytes), TNTIDX by numpy following the layout in the
module docstring, in ``uint16`` and ``int32`` tokens. Each package's
``LegacyIndexedDataset`` reads the other's files with equal sizes,
items and spans; ``FileDataset`` reads what ``MemoryMapDataset`` reads;
``TextDataset(..., legacy_dataset=True)`` packs items equal to JAX's with
``only_full_sequences`` off and on; and a ``data.legacy_dataset`` config
trains the port's Trainer to the losses of the same documents in a
memory map. Index computations only: everything is compared exactly.
"""

import struct

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from scaling_tpu.data.file_dataset import FileDataset as JaxFileDataset  # noqa: E402
from scaling_tpu.data.legacy_indexed_dataset import (  # noqa: E402
    LegacyIndexedDataset as JaxLegacy,
)
from scaling_tpu.data.legacy_indexed_dataset import (  # noqa: E402
    LegacyMMapIndexWriter as JaxLegacyWriter,
)
from scaling_tpu.data.memory_map import MemoryMapDataset as JaxMemoryMap  # noqa: E402
from scaling_tpu.models.transformer.data.text_dataset import (  # noqa: E402
    TextDataset as JaxTextDataset,
)
from scaling_tpu_torch.data import (  # noqa: E402
    FileDataset,
    LegacyIndexedDataset,
    LegacyMMapIndexWriter,
    MemoryMapDataset,
    MemoryMapDatasetBuilder,
)
from scaling_tpu_torch.models.transformer.data import TextDataset  # noqa: E402

from .test_torch_parity_helpers import one_torch_thread  # noqa: E402,F401

SEQ = 32
DTYPES = {"uint16": np.uint16, "int32": np.int32}
CODES = {np.dtype(np.uint16): 8, np.dtype(np.int32): 4}
FIELDS = ("token_ids", "target_token_ids", "position_ids", "segment_ids", "loss_weights")


def documents(seed, n=24, low=4, high=90, vocab=96):
    rng = np.random.default_rng(seed)
    return [np.append(rng.integers(1, vocab, size=rng.integers(low, high)), 0) for _ in range(n)]


def write_mmidx(writer_cls, prefix, docs, dtype):
    with writer_cls(prefix, dtype=dtype) as w:
        for d in docs:
            w.add(d)
    return prefix


def write_tntidx(prefix, docs, dtype, dims=None):
    """The TNTIDX layout by hand; ``dims`` gives an item's shape (one dim
    a document when None)."""
    dtype = np.dtype(dtype)
    dims = dims or [(len(d),) for d in docs]
    sizes = np.asarray([s for shape in dims for s in shape], np.int64)
    dim_offsets = np.concatenate([[0], np.cumsum([len(s) for s in dims])]).astype(np.int64)
    data_offsets = np.concatenate([[0], np.cumsum([len(d) for d in docs])]).astype(np.int64)
    doc_idx = np.arange(len(docs) + 1, dtype=np.int64)
    with open(prefix.with_suffix(".bin"), "wb") as f:
        for d in docs:
            f.write(np.asarray(d, dtype).tobytes())
    with open(prefix.with_suffix(".idx"), "wb") as f:
        f.write(b"TNTIDX\x00\x00")
        f.write(struct.pack("<QQQQQQ", 1, CODES[dtype], dtype.itemsize, len(docs), len(sizes),
                            len(doc_idx)))
        for arr in (dim_offsets, data_offsets, sizes, doc_idx):
            f.write(arr.tobytes())
    return prefix


def assert_same_store(port, ref, docs=None):
    assert len(port) == len(ref)
    assert port.dtype == ref.dtype
    np.testing.assert_array_equal(port.sizes(), ref.sizes())
    assert port.sizes().dtype == np.int64
    np.testing.assert_array_equal(np.asarray(port.doc_idx), np.asarray(ref.doc_idx))
    for i in range(len(ref)):
        np.testing.assert_array_equal(port[i], ref[i])
        if docs is not None:
            np.testing.assert_array_equal(port[i], docs[i])
    total = int(ref.sizes().sum())
    for start, n in ((0, 17), (5, 40), (total - 9, 9), (total - 3, 10)):
        np.testing.assert_array_equal(port.read_span(start, n), ref.read_span(start, n))


@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
def test_mmidx_written_by_jax_reads_alike_in_both(tmp_path, dtype):
    docs = documents(1)
    prefix = write_mmidx(JaxLegacyWriter, tmp_path / "jax", docs, DTYPES[dtype])
    assert_same_store(LegacyIndexedDataset(prefix), JaxLegacy(prefix), docs)
    assert_same_store(LegacyIndexedDataset(prefix, load_index_to_memory=True),
                      JaxLegacy(prefix, load_index_to_memory=True))


@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
def test_port_writer_writes_jax_writers_bytes(tmp_path, dtype):
    docs = documents(2)
    port = write_mmidx(LegacyMMapIndexWriter, tmp_path / "port", docs, DTYPES[dtype])
    ref = write_mmidx(JaxLegacyWriter, tmp_path / "jax", docs, DTYPES[dtype])
    for suffix in (".bin", ".idx"):
        assert port.with_suffix(suffix).read_bytes() == ref.with_suffix(suffix).read_bytes()
    assert_same_store(LegacyIndexedDataset(port), JaxLegacy(port), docs)


@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
def test_tntidx_reads_alike_in_both(tmp_path, dtype):
    docs = documents(3)
    prefix = write_tntidx(tmp_path / "cached", docs, DTYPES[dtype])
    assert_same_store(LegacyIndexedDataset(prefix), JaxLegacy(prefix), docs)


def test_tntidx_items_of_several_dims_count_their_product(tmp_path):
    docs = [np.arange(1, 7), np.arange(1, 5), np.arange(1, 10)]
    prefix = write_tntidx(tmp_path / "dims", docs, np.uint16, dims=[(2, 3), (4,), (3, 3)])
    port, ref = LegacyIndexedDataset(prefix), JaxLegacy(prefix)
    np.testing.assert_array_equal(port.sizes(), [6, 4, 9])
    assert_same_store(port, ref, docs)


def test_a_file_that_is_no_megatron_index_is_refused(tmp_path):
    prefix = tmp_path / "junk"
    prefix.with_suffix(".idx").write_bytes(b"NOTANIDX" + bytes(32))
    prefix.with_suffix(".bin").write_bytes(bytes(8))
    with pytest.raises(ValueError, match="not a Megatron"):
        LegacyIndexedDataset(prefix)


def test_file_dataset_reads_what_the_memory_maps_read(tmp_path):
    docs = documents(4, high=140)
    prefix = tmp_path / "mmap"
    with MemoryMapDatasetBuilder(prefix, dtype=np.uint16) as b:
        for d in docs:
            b.add(d)
    port, ref = FileDataset(prefix), JaxFileDataset(prefix)
    maps = (MemoryMapDataset(prefix), JaxMemoryMap(prefix))
    try:
        assert len(port) == len(ref) == len(docs) and port.dtype == ref.dtype
        for m in maps:
            np.testing.assert_array_equal(port.sizes(), m.sizes())
        for i in (0, 7, len(docs) - 1):
            for other in (ref, *maps):
                np.testing.assert_array_equal(port[i], other[i])
            np.testing.assert_array_equal(port[i], docs[i])
            assert port.sizes(i) == len(docs[i])
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("layout", ["mmidx", "tntidx"])
@pytest.mark.parametrize("full", [False, True], ids=["stream", "only_full_sequences"])
def test_text_dataset_over_legacy_data_gives_jaxs_items(tmp_path, layout, full):
    """As tests/core/test_data/test_legacy_indexed.py builds it, with
    over-long documents so that both packings cut."""
    docs = documents(5, n=30, low=5, high=3 * SEQ)
    prefix = (write_mmidx(LegacyMMapIndexWriter, tmp_path / "legacy", docs, np.uint16)
              if layout == "mmidx" else write_tntidx(tmp_path / "legacy", docs, np.uint16))
    kw = dict(sequence_length=SEQ, seed=1, only_full_sequences=full, legacy_dataset=True)
    port, ref = TextDataset(prefix, **kw), JaxTextDataset(prefix, **kw)
    assert isinstance(port.memory_map, LegacyIndexedDataset)
    assert len(port) == len(ref) > 0
    for i in range(len(ref)):
        np.testing.assert_array_equal(port[i].token_ids, ref[i].token_ids)
    if not full:
        np.testing.assert_array_equal(port[0].token_ids, np.concatenate(docs)[:SEQ + 1])
    items = [0, 1, len(ref) - 1]
    pb, rb = port.collate([port[i] for i in items]), ref.collate([ref[i] for i in items])
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(pb, field), getattr(rb, field), err_msg=field)


ARCH = {
    "vocab_size": 96, "hidden_size": 32, "num_layers": 1, "num_attention_heads": 2,
    "sequence_length": SEQ, "precision": "float32", "mlp_type": "swiglu", "mlp_factor": 2.0,
    "norm_type": "rms", "weight_tying": False,
}


def trainer_config(prefixes, legacy: bool, **data):
    from scaling_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig.from_dict({
        "topology": {"micro_batch_size": 2, "gradient_accumulation_steps": 1},
        "transformer_architecture": ARCH,
        "learning_rate_scheduler": {"learning_rate": 0.01, "learning_rate_warmup_steps": 1,
                                    "learning_rate_decay_iters": 10},
        "trainer": {"train_iterations": 3, "seed": 3},
        "data": {"data_prefixes": [str(p) for p in prefixes], "legacy_dataset": legacy,
                 "only_full_sequences": True, **data},
        "logger": {"log_dir": None},
    })


def test_legacy_dataset_config_trains_as_the_memory_map_of_its_documents(tmp_path):
    """``data.legacy_dataset: true`` over a blend of an MMIDIDX and a TNTIDX
    dataset loads, and 3 Trainer steps give the losses of the same
    documents written as memory maps: the Trainer sees the same batches."""
    from scaling_tpu_torch.models.transformer.train import build_trainer

    blends = {"a": documents(6, n=30), "b": documents(7, n=20, high=2 * SEQ)}
    legacy = [write_mmidx(LegacyMMapIndexWriter, tmp_path / "a", blends["a"], np.uint16),
              write_tntidx(tmp_path / "b", blends["b"], np.int32)]
    mmaps = []
    for name, docs in blends.items():
        with MemoryMapDatasetBuilder(tmp_path / f"mm_{name}", dtype=np.int32) as b:
            for d in docs:
                b.add(d)
        mmaps.append(tmp_path / f"mm_{name}")
    config = trainer_config(legacy, True, allow_incomplete_sequences_every_n=2)
    assert config.data.legacy_dataset is True
    losses = {}
    for name, cfg in (("legacy", config),
                      ("mmap", trainer_config(mmaps, False, allow_incomplete_sequences_every_n=2))):
        trainer = build_trainer(cfg, device="cpu")
        stores = [type(d.memory_map) for d in trainer.dataset.datasets]
        assert stores == [LegacyIndexedDataset if name == "legacy" else MemoryMapDataset] * 2
        losses[name] = [float(trainer.train_step().loss) for _ in range(3)]
    assert losses["legacy"] == losses["mmap"]
    assert all(np.isfinite(losses["legacy"]))
