"""How the port names its kernel builds: by a hash of the source and of the
headers beside it, so that an edited source or header is rebuilt and an
unchanged one is not. No compiler is needed."""

from vae_gan_mark_tpu_torch.ops import cuda_build


def test_library_path_follows_source_and_headers(tmp_path):
    source = tmp_path / "kernel.cu"
    header = tmp_path / "shared.cuh"
    source.write_text('#include "shared.cuh"\n')
    header.write_text("// first\n")
    first = cuda_build.library_path(source)
    assert first == cuda_build.library_path(source)
    assert first.parent == cuda_build.BUILD_DIR
    assert first.name.startswith("libkernel_") and first.suffix == ".so"
    header.write_text("// second\n")
    second = cuda_build.library_path(source)
    assert second != first
    source.write_text('#include "shared.cuh"\n// edited\n')
    assert cuda_build.library_path(source) not in (first, second)


def test_port_sources_share_the_exchange_header():
    """Both GRU kernels include the exchange header that sits beside them,
    so its edits reach both builds."""
    header = cuda_build.CSRC / "cluster_exchange.cuh"
    assert header.exists()
    for name in ("gru_fwd.cu", "gru_bwd.cu"):
        assert '#include "cluster_exchange.cuh"' in (
            cuda_build.CSRC / name).read_text()
