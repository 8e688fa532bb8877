"""The port's C++ pack-index builder against its plain loop and the JAX
package's builder.

``scaling_tpu_torch/native/pack_index.cpp`` is compiled here with ``g++``
into a temporary build directory. Its ``only_full_sequences`` windows
over documents drawn from a seed (as tests/core/test_native_pack_index.py
draws them, and with over-long documents) equal the port's plain loop
and ``scaling_tpu.native.build_pack_index`` exactly, over several seeds,
sequence lengths and ``allow_incomplete_sequences_every_n``. A compiler
that does not exist raises instead of falling back.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from scaling_tpu.native import build_pack_index as jax_build_pack_index  # noqa: E402
from scaling_tpu.native import native_available  # noqa: E402
from scaling_tpu_torch import native  # noqa: E402
from scaling_tpu_torch.data import MemoryMapDatasetBuilder  # noqa: E402
from scaling_tpu_torch.models.transformer.data import TextDataset  # noqa: E402


@pytest.fixture(scope="module")
def build_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("pack_index_build")


def doc_sizes(seed: int, n: int, low: int, high: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(low, high, size=n).astype(np.int64)


@pytest.mark.parametrize("every_n", [0, 1, 3, 4])
@pytest.mark.parametrize("seq,low,high", [(32, 4, 91), (32, 1, 200), (7, 1, 9), (2048, 16, 8192)],
                         ids=["short-docs", "long-docs", "tiny-seq", "phase17-shape"])
@pytest.mark.parametrize("seed", [0, 7, 11])
def test_cpp_builder_equals_the_plain_loop_and_jaxs(build_dir, seed, seq, low, high, every_n):
    sizes = doc_sizes(seed, 300, low, high)
    starts, ends = native.build_pack_index(sizes, seq, every_n, build_dir=build_dir)
    plain_starts, plain_ends = native.build_pack_index_plain(sizes, seq, every_n)
    assert starts.dtype == ends.dtype == np.int64
    np.testing.assert_array_equal(starts, plain_starts)
    np.testing.assert_array_equal(ends, plain_ends)
    assert len(starts) > 0 and (ends - starts).max() <= seq + 1 and (ends - starts).min() >= 2
    if native_available():
        jax_starts, jax_ends = jax_build_pack_index(sizes, seq, every_n)
        np.testing.assert_array_equal(starts, jax_starts)
        np.testing.assert_array_equal(ends, jax_ends)


@pytest.mark.parametrize("sizes", [[], [1], [2], [0, 0, 5], [40], [33, 1, 33]],
                         ids=["none", "one-token", "two-tokens", "empties", "one-long", "edges"])
def test_cpp_builder_equals_the_plain_loop_at_the_edges(build_dir, sizes):
    for every_n in (0, 1, 2):
        got = native.build_pack_index(np.asarray(sizes, np.int64), 32, every_n,
                                      build_dir=build_dir)
        want = native.build_pack_index_plain(np.asarray(sizes, np.int64), 32, every_n)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_text_dataset_packs_with_the_cpp_builder(tmp_path, build_dir):
    rng = np.random.default_rng(3)
    prefix = tmp_path / "data"
    with MemoryMapDatasetBuilder(prefix, dtype=np.uint16) as b:
        for _ in range(64):
            b.add(np.append(rng.integers(1, 200, size=rng.integers(3, 90)), 0).astype(np.uint16))
    ds = TextDataset(prefix, sequence_length=32, seed=1, only_full_sequences=True,
                     allow_incomplete_sequences_every_n=3)
    # the library TextDataset loaded is the one the package builds into _build/
    assert native.library_path() in native._LIBS
    starts, ends = native.build_pack_index_plain(ds.memory_map.sizes(), 32, 3)
    np.testing.assert_array_equal(ds._item_starts, starts)
    np.testing.assert_array_equal(ds._item_ends, ends)
    assert len(ds) == len(starts)


def test_a_failed_build_raises_with_the_compilers_message(tmp_path):
    with pytest.raises(RuntimeError, match="no compiler 'no-such-g\\+\\+'"):
        native.load(build_dir=tmp_path, compiler="no-such-g++")
    with pytest.raises(RuntimeError, match="failed"):
        native.load(build_dir=tmp_path, compiler="false")  # exits 1, prints nothing
    assert not list(tmp_path.glob("*.so"))


def test_bad_inputs_are_refused(build_dir):
    with pytest.raises(ValueError):
        native.build_pack_index(np.asarray([3, -1]), 32, 0, build_dir=build_dir)
    with pytest.raises(ValueError):
        native.build_pack_index_plain(np.asarray([3, 4]), 0, 0)
