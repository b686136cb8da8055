"""K8's cooperative launch (``multi_circulant_launch``), on the CPU: for given
card limits the grid is the check sweep's work tiles or the blocks the card
holds resident, the fewer.  Also that the decode entry of
``circulant_multi.cu`` is one cooperative launch with no copy to the host and
no synchronisation, and that the edited copies ``tools/k8_variants.py``
writes for the forms tool still apply to the source.  That the blocks' grid
stride covers every tile is tested on the card, at grids 1, 2 and the
resident maximum (``tests/test_torch_cuda_multi.py``).  And that
``multi_lib_installed`` gives the wrapper another library and restores its own."""

import re
from pathlib import Path

import pytest

from sca_ldpc_tpu_torch.ops.kernels.circulant_cuda import MULTI_THREADS, multi_circulant_launch
from sca_ldpc_tpu_torch.tools import k8_variants

SOURCE = Path(__file__).resolve().parents[1] / "sca_ldpc_tpu_torch" / "csrc" / "circulant_multi.cu"
H100 = (3, 132)  # 80 registers and 256 threads a block: 3 blocks an SM, 132 SMs
SMALL = (1, 2)  # a card limit below most cells' work


@pytest.mark.parametrize("batch,p,n,limits,row_tiles,grid", [
    (1, 1, 17669, H100, 70, 70),  # the attack's recovery decode: one frame over 70 blocks
    (16, 1, 17669, H100, 1120, 396),
    (17, 1, 17669, H100, 1190, 396),
    (1, 3, 17669, H100, 210, 210),
    (1, 8, 17669, H100, 560, 396),
    (16, 8, 17669, H100, 8960, 396),
    (1, 1, 20, H100, 1, 1),
    (17, 3, 40, H100, 51, 51),
    (16, 8, 20, SMALL, 128, 2),
    (1, 1, 20, SMALL, 1, 1),
    (17, 8, 17669, SMALL, 9520, 2),
])
def test_grid(batch, p, n, limits, row_tiles, grid):
    cfg = multi_circulant_launch(batch, p, n, *limits)
    assert cfg.threads == MULTI_THREADS
    assert cfg.row_tiles == row_tiles and cfg.var_tiles == row_tiles // p
    assert cfg.grid == grid <= limits[0] * limits[1]


@pytest.mark.parametrize("bad", [(0, 1, 20, 3, 132), (1, 0, 20, 3, 132), (1, 1, 0, 3, 132), (1, 1, 20, 0, 132)])
def test_launch_rejects(bad):
    with pytest.raises(ValueError):
        multi_circulant_launch(*bad)


def test_decode_entry_is_one_cooperative_launch():
    src = SOURCE.read_text()
    entry = src[src.index('extern "C" int multi_circulant_bp_decode'):src.index('extern "C" int multi_circulant_bp_occupancy')]
    assert entry.count("cudaLaunchCooperativeKernel(") == 1
    assert "<<<" not in src
    assert not re.search(r"cudaMemcpy|Synchronize|cudaMalloc", src)
    assert src.count("grid.sync()") == 3  # the barriers of an iteration


@pytest.mark.parametrize("name", [*k8_variants.FLOORS, "stage2"])
def test_k8_variants_apply(tmp_path, name):
    """Every edit of every copy applies to the current source: the floor
    copies keep the loop and its three barriers and drop the work of the
    sweeps after their first ``FLOORS[name]``; stage 2 has two barriers an
    iteration and returns the syndrome test from the check update."""
    text = k8_variants.write(tmp_path)[name].read_text()
    if name == "stage2":
        assert text.count("grid.sync()") == 2 and "return test && (s & 1) != syn;" in text
    else:
        assert text.count("grid.sync()") == 3
        assert text.count("false && tile < ") == 3 - k8_variants.FLOORS[name]
        assert "run[x] = ~0u;" in text


def test_multi_lib_installed_restores():
    """Within ``multi_lib_installed`` K8's wrapper finds the given library;
    after the block, also one left by an exception, it finds its own again.
    A ``TimedMultiLib`` passes every other name through to its library."""
    from types import SimpleNamespace

    from sca_ldpc_tpu_torch.ops.kernels import circulant_cuda

    original = circulant_cuda._multi_lib
    lib = SimpleNamespace(multi_circulant_bp_occupancy=len)
    timed = circulant_cuda.TimedMultiLib(lib)
    with circulant_cuda.multi_lib_installed(timed) as got:
        assert got is timed and circulant_cuda._multi_lib() is timed
        assert circulant_cuda._multi_lib().multi_circulant_bp_occupancy is len
    assert circulant_cuda._multi_lib is original
    with pytest.raises(ValueError, match="inside"):
        with circulant_cuda.multi_lib_installed(lib):
            raise ValueError("inside")
    assert circulant_cuda._multi_lib is original
    assert timed.events == [] and timed.seconds() == 0
