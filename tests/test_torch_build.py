"""The kernel library's host side on the CPU: every ctypes signature in
``kernels/build.py`` against its ``extern "C"`` declaration in
``kernels/csrc`` (the number of arguments and whether each is a pointer),
every declaration against a signature, and ``ptxas_report`` on hand-made
``-Xptxas -v`` messages."""

from __future__ import annotations

import ctypes
import glob
import os
import re

import pytest

from irdu_tpu_torch.kernels import build

SIGNATURES = sorted(build._SIGNATURES)


def _declarations():
    """{name: [parameter text]} of every extern "C" function in csrc."""
    out = {}
    for path in glob.glob(os.path.join(build.CSRC_DIR, "*.cu")):
        with open(path) as fh:
            text = fh.read()
        for m in re.finditer(r'extern "C"[^(;{]*?\b(irdu_\w+)\s*\(([^)]*)\)', text):
            params = " ".join(m.group(2).split())
            out[m.group(1)] = [] if params in ("", "void") else params.split(",")
    return out


@pytest.mark.parametrize("name", SIGNATURES)
def test_signature_matches_the_source(name):
    """The ctypes argument list has the C declaration's length, with a
    pointer exactly where the declaration has one."""
    decl = _declarations()
    assert name in decl, f"{name} is declared in no source under kernels/csrc"
    argtypes, _ = build._SIGNATURES[name]
    params = decl[name]
    assert len(argtypes) == len(params), (name, params)
    for arg, param in zip(argtypes, params):
        assert (arg is ctypes.c_void_p) == ("*" in param), (name, param)


def test_every_declaration_is_bound():
    """The library exports exactly the functions the signature table binds:
    no source under kernels/csrc declares an entry point that nothing
    loads."""
    assert sorted(_declarations()) == SIGNATURES


LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN4irdu3pix19pixel_unroll_kernelI13__nv_bfloat16Li32ELi64ELi512ELi1EEEvNS0_4ArgsIT_EE' for 'sm_90a'
ptxas info    : Function properties for _ZN4irdu3pix19pixel_unroll_kernelI13__nv_bfloat16Li32ELi64ELi512ELi1EEEvNS0_4ArgsIT_EE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 480 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN4irdu3pix19pixel_unroll_kernelIfLi16ELi64ELi256ELi1EEEvNS0_4ArgsIT_EE' for 'sm_90a'
ptxas info    : Function properties for _ZN4irdu3pix19pixel_unroll_kernelIfLi16ELi64ELi256ELi1EEEvNS0_4ArgsIT_EE
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 219 registers, used 1 barriers, 480 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN4irdu6matvec20system_matvec_kernelIfLi16ELi16ELi8ELi256ELi2ELb1EEEvNS0_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN4irdu6matvec20system_matvec_kernelIfLi16ELi16ELi8ELi256ELi2ELb1EEEvNS0_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 126 registers, used 1 barriers, 432 bytes cmem[0]
"""


@pytest.mark.parametrize("match,want", [
    ("pixel_unroll_kernel", [(128, 0, 0, 0), (219, 8, 4, 12)]),
    ("system_matvec_kernel", [(126, 0, 0, 0)]),
    ("gated_block", []),
], ids=["two_instances", "one_instance", "none"])
def test_ptxas_report(match, want):
    """Each entry function whose name holds ``match`` gets its own
    registers, stack and spills, in the log's order."""
    got = build.ptxas_report(LOG, match)
    assert [(r["registers"], r["stack"], r["spill_stores"], r["spill_loads"])
            for r in got] == want
    assert all(match in r["name"] for r in got)


def test_ptxas_report_of_an_empty_log():
    """A library that was already built leaves no messages: no entries."""
    assert build.ptxas_report("", "pixel_unroll_kernel") == []


SASS = """
\tcode for sm_90a
\t\tFunction : _ZN4irdu6unroll16gg_unroll_kernelIfEEvNS0_4ArgsIT_EE
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   EXIT ;
\t\tFunction : _ZN4irdu6unroll16gg_unroll_kernelI13__nv_bfloat16EEvNS0_4ArgsIT_EE
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   EXIT ;
"""


def test_sass_digests_tell_functions_apart():
    """``ab_sources.sass_digests``: one digest per entry function of a
    ``cuobjdump -sass`` listing; equal code gives equal digests, and one
    changed instruction changes only its function's."""
    from irdu_tpu_torch.kernels.ab_sources import sass_digests

    got = sass_digests(SASS)
    assert len(got) == 2 and len(set(got.values())) == 1
    changed = sass_digests(SASS.replace("EXIT ;", "BRA 0x0 ;", 1))
    names = list(got)
    assert changed[names[0]] != got[names[0]] and changed[names[1]] == got[names[1]]


def test_kernel_sources_name_their_headers():
    """chip_smoke.py's ``source_headers``: the repo headers a kernel source
    includes, directly or through a header (K5/K6a/K6b and K7 on their own
    header and through it the padded tile, K1 on its own header, its tile
    step and the padded tile's windows, K3's dw_mxu kernel on the Hopper
    helpers), each a file in the repo."""
    import importlib.util

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(repo, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    csrc = "irdu_tpu_torch/kernels/csrc"
    for source, want in (("fused_step_hopper.cu", ["fused_step_hopper.cuh", "padded_tile.cuh"]),
                         ("pixel_unroll.cu", ["pixel_unroll.cuh", "padded_tile.cuh"]),
                         ("gg_unroll.cu", ["gg_unroll.cuh", "tile_step.cuh", "padded_tile.cuh"]),
                         ("block_stack_dw_mxu.cu", ["hopper.cuh"]),
                         ("edge_weights.cu", [])):
        got = smoke.source_headers(f"{csrc}/{source}")
        assert got == [f"{csrc}/{h}" for h in want], source
        assert all(os.path.isfile(os.path.join(repo, h)) for h in got)
