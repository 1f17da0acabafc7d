"""The port's kernel build on the CPU: what enters a library's digest, the
headers each GRU source includes, and the ptxas report parser.  Nothing is
compiled here."""

import os
import re

from deeprest_tpu_torch.ops import build, cuda_gru


def _source(tmp_path, src=b"// kernel\n", hdr=b"// helpers\n"):
    (tmp_path / "k.cu").write_bytes(src)
    (tmp_path / "h.cuh").write_bytes(hdr)
    return build.CudaSource("k.cu", {}, headers=("h.cuh",),
                            csrc_dir=str(tmp_path))


def test_library_digest_covers_source_and_headers(tmp_path):
    first = _source(tmp_path).library_path()
    assert first == _source(tmp_path).library_path()
    assert os.path.basename(first).startswith("libk-")
    header_edit = _source(tmp_path, hdr=b"// helpers, edited\n").library_path()
    source_edit = _source(tmp_path, src=b"// kernel, edited\n").library_path()
    assert len({first, header_edit, source_edit}) == 3
    assert os.path.dirname(first) == build.BUILD_DIR


def test_gru_sources_list_every_local_include():
    """Each source's digest covers the csrc headers it includes: a header
    edit rebuilds gru_fwd.cu and gru_bwd.cu."""
    for src in cuda_gru.SOURCES:
        with open(src.source) as fh:
            local = set(re.findall(r'#include "([^"]+)"', fh.read()))
        assert {os.path.basename(h) for h in src.headers} == local, src.name
        assert all(os.path.isfile(h) for h in src.headers)
    mma = os.path.join(build.CSRC_DIR, "gru_mma.cuh")
    assert mma in cuda_gru.GRU_FWD_SOURCE.headers
    assert mma in cuda_gru.GRU_BWD_SOURCE.headers


def test_ptxas_usage_reads_registers_and_spills():
    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        "ptxas info    : Compiling entry function '_Z4fastv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z4fastv",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 95 registers, 384 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_Z4slowv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z4slowv",
        "    8 bytes stack frame, 12 bytes spill stores, 24 bytes spill loads",
        "ptxas info    : Used 128 registers, 384 bytes cmem[0]",
    ])
    assert build.ptxas_usage(log) == {
        "_Z4fastv": {"registers": 95, "spill_bytes": 0},
        "_Z4slowv": {"registers": 128, "spill_bytes": 36}}
    assert build.ptxas_usage("") == {}
