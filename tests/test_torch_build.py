"""The port's kernel build: libraries are named by a hash of everything
that goes into them, so an edited source, header or flag never loads a
stale library.  Nothing here runs nvcc."""
from mxnet_tpu_torch.ops import _build


def _sources(tmp_path):
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n'
                                   '#include <cuda_runtime.h>\n'
                                   'extern "C" int k() { return A; }\n')
    (tmp_path / "common.cuh").write_text('#include "inner.cuh"\n')
    (tmp_path / "inner.cuh").write_text("#define A 1\n")
    (tmp_path / "unused.cuh").write_text("#define B 1\n")


def test_library_name_follows_source_headers_and_flags(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    _sources(tmp_path)
    first = _build.library_path("k")
    assert first.parent == _build.BUILD_DIR
    assert first.name.startswith("libk-") and first.suffix == ".so"
    assert _build.library_path("k") == first
    # a header the source does not include changes nothing
    (tmp_path / "unused.cuh").write_text("#define B 2\n")
    assert _build.library_path("k") == first
    # a header it includes, directly or through another header, does
    (tmp_path / "inner.cuh").write_text("#define A 2\n")
    second = _build.library_path("k")
    assert second != first
    (tmp_path / "common.cuh").write_text('#include "inner.cuh"\n// edit\n')
    third = _build.library_path("k")
    assert third not in (first, second)
    # and so does a compiler flag
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("k") not in (first, second, third)


def test_every_kernel_source_is_in_the_checkout():
    for name in _build.KERNEL_SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
        assert _build.library_path(name).name.startswith(f"lib{name}-")


def test_the_tensor_core_fused_kernel_is_built():
    """Both fused conv-BN kernels are built, so every call reaches one."""
    assert {"fused_conv_bn", "fused_conv_bn_wgmma"} <= set(
        _build.KERNEL_SOURCES)


def test_the_tensor_core_flash_kernels_are_built():
    """All three flash kernels are built, so every call reaches one: fp32
    on the tensor cores (three TF32 products), bf16 on the tensor cores and
    the CUDA-core kernel for the rest."""
    assert {"flash_fwd", "flash_fwd_tf32", "flash_fwd_wgmma"} <= set(
        _build.KERNEL_SOURCES)
