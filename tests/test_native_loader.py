"""Native C++ loader parity with the numpy layout path (gvamp/native)."""

import numpy as np
import pytest

from gvamp import native
from gvamp.io import plink
from gvamp.ops.layout import PlanarLayout

pytestmark = pytest.mark.skipif(native.get_lib() is None,
                                reason="no C++ toolchain")


@pytest.mark.parametrize("N,M", [(61, 33), (4, 1), (257, 513), (1000, 40)])
def test_bed_to_words_matches_numpy(N, M):
    rng = np.random.default_rng(N * 1000 + M)
    lay = PlanarLayout.create(N)
    by = rng.integers(0, 256, size=(M, lay.mbytes), dtype=np.uint8)
    Mpad = ((M + 7) // 8) * 8
    ref = np.full((lay.n_words, Mpad), 0x55555555, dtype=np.uint32)
    ref[:, :M] = lay.pack_words(by).T
    got = native.bed_to_words(by, N, lay.n_words, Mpad)
    np.testing.assert_array_equal(got, ref)


def test_read_bed_words_matches_numpy(tmp_path):
    rng = np.random.default_rng(5)
    N, M = 143, 37
    codes = rng.integers(0, 4, size=(M, N)).astype(np.uint8)
    p = str(tmp_path / "t.bed")
    plink.write_bed(p, codes)
    lay = PlanarLayout.create(N)
    by = plink.read_bed_slab(p, N, M)
    Mpad = 64
    ref = np.full((lay.n_words, Mpad), 0x55555555, dtype=np.uint32)
    ref[:, :M] = lay.pack_words(by).T
    got = native.read_bed_words(p, N, M, 0, lay.n_words, Mpad)
    np.testing.assert_array_equal(got, ref)
    # sub-slab with offset
    ref2 = np.full((lay.n_words, Mpad), 0x55555555, dtype=np.uint32)
    ref2[:, :M - 11] = lay.pack_words(by[11:]).T
    got2 = native.read_bed_words(p, N, M - 11, 11, lay.n_words, Mpad)
    np.testing.assert_array_equal(got2, ref2)
