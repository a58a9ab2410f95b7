"""Per-kernel compiler flags of the port's CUDA build (no compiler needed).

The fabric, pack and quant8 kernels are bitwise against their plain
versions, so they are built without FMA contraction; the flash kernels
are held within tolerances and may contract.  Each library is named by a
hash of its source and its own flags, so a change of either rebuilds it.
"""

import pytest

from repro_torch.kernels import build


@pytest.mark.parametrize("name", build.KERNELS)
def test_flags_per_kernel(name):
    flags = build.nvcc_flags(name)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert ("-Xptxas", "-v") == flags[flags.index("-Xptxas"):][:2]
    if name in build.BITWISE:
        assert "-fmad=false" in flags
    else:
        assert not any(f.startswith("-fmad") for f in flags)


def test_bitwise_kernels_keep_exact_arithmetic():
    assert set(build.BITWISE) == {"fabric_scan", "bucket_pack", "quant8"}
    assert "flash_attention" not in build.BITWISE
    assert build.nvcc_flags("flash_attention") != build.nvcc_flags("quant8")


def test_library_hash_covers_source_and_flags(monkeypatch):
    paths = {name: build.library_path(name) for name in build.KERNELS}
    assert len(set(paths.values())) == len(build.KERNELS)
    assert all(p.parent == build.BUILD_DIR and p.name.startswith(f"lib{n}-")
               for n, p in paths.items())
    # the same source under other flags is another library
    monkeypatch.setattr(build, "BITWISE", ())
    for name in ("fabric_scan", "bucket_pack", "quant8"):
        assert build.library_path(name) != paths[name]
    assert build.library_path("flash_attention") == paths["flash_attention"]
    assert build.log_path("quant8").suffix == ".log"
