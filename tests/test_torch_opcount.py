"""The operation-count tools of kernels/opcount.py and the ptxas report
of kernels/_build.py, on the kernels' sources and on small SASS and
compiler-log texts in the formats of ``nvdisasm -g -gi`` and ``-Xptxas
-v``. (The count itself needs the GPU build and runs in chip_smoke.py.)"""

import pytest

from cloudmicrophysics_tpu_torch.kernels import _build, opcount

SOURCE = (_build.CSRC_DIR / "column_p3.cu").read_text()


def test_every_region_has_one_site_in_a_block():
    names = opcount.region_names(SOURCE)
    sites = opcount.probe_sites(SOURCE)
    assert names[0] == "R_SOLVE" and "R_COUNT" not in names
    assert set(sites) == set(names)
    lines = SOURCE.splitlines()
    for name, site in sites.items():
        assert site.start <= site.end
        block = "\n".join(lines[site.start - 1:site.end])
        assert f"K5_COUNT({name}" in block
        assert site.unroll in (1, 4)
    # the partly unrolled loops of the incomplete gamma say so
    assert sites["R_GI_SERIES_IT"].unroll == 4
    assert sites["R_GI_CF_IT"].unroll == 4
    assert sites["R_BRENT_IT"].unroll == 1
    assert sites["R_GI_SERIES2_IT"].unroll == sites["R_SUM_IT"].unroll == 4
    # nested regions: a loop body inside its arm
    outer, inner = sites["R_GI_SERIES"], sites["R_GI_SERIES_IT"]
    assert outer.start < inner.start <= inner.end < outer.end
    # K5c's regions are the blocks its active threads run
    for name in ("R_EPI", "R_EPI_OUT"):
        assert lines[sites[name].start - 1].strip() == "if (active) {"


@pytest.mark.parametrize("source", ["column1m.cu", "column2m.cu"])
def test_function_block_finds_cell_step(source):
    text = (_build.CSRC_DIR / source).read_text()
    lines = text.splitlines()
    site = opcount.function_block(text, "cell_step")
    assert site.unroll == 1
    # the body opens at the end of the signature and closes the function
    head = max(i for i in range(1, site.start + 1)
               if "cell_step(" in lines[i - 1])
    assert "{" not in "".join(lines[head - 1:site.start - 1])
    assert lines[site.start - 1].endswith("{") and lines[site.end - 1] == "}"
    # the kernel that calls it lies outside
    kernel = next(i for i, line in enumerate(lines, 1)
                  if line.startswith("__global__"))
    assert site.end < kernel


@pytest.mark.parametrize("text,match", [
    ("void f() { K5_COUNT(R_A); K5_COUNT(R_A); }", "two K5_COUNT sites"),
    ("K5_COUNT(R_A);", "outside any block"),
    ("void f() { {", "unbalanced '{'"),
    ("} void f() {}", "unbalanced '}'"),
])
def test_probe_sites_rejects(text, match):
    with pytest.raises(ValueError, match=match):
        opcount.probe_sites(text)


def test_region_names_follow_the_enum():
    text = "enum ProbeRegion {\n  R_B, R_A,  // a comment\n  R_C,\n  R_COUNT\n};"
    assert opcount.region_names(text) == ["R_B", "R_A", "R_C"]
    with pytest.raises(ValueError, match="ProbeRegion"):
        opcount.region_names("enum Other { X };")


SASS = """
        .section        .text._Z6kernelv,"ax",@progbits
.text._Z6kernelv:
        //## File "/src/k.cu", line 3
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   NOP ;
        //## File "/inc/math.h", line 90 inlined at "/src/k.cu", line 5
        /*0020*/              @!P0 FMUL R2, R2, R3 ;
        /*0030*/                   MUFU.EX2 R2, R2 ;
        //## File "/src/k.cu", line 12 inlined at "/src/k.cu", line 6
        /*0040*/                   FADD R2, R2, R4 ;
        //## File "/src/k.cu", line 12 inlined at "/src/k.cu", line 7
        /*0050*/                   FADD R2, R2, R5 ;
        /*0060*/                   FADD R2, R2, R6 ;
        //## File "/inc/div.h", line 4
        /*0070*/                   MUFU.RCP R0, R0 ;
        /*0080*/                   EXIT ;
$__internal_0_$__cuda_sm3x_div_rn_noftz_f32_slowpath:
        //## File "/src/k.cu", line 3
        /*0090*/                   FFMA R0, R1, R2, R3 ;
        /*00a0*/                   RET.REL.NODEC R2 `(_Z6kernelv) ;
        .section        .text._Z4halfv,"ax",@progbits
.text._Z4halfv:
        /*0000*/                   EXIT ;
"""

# k.cu: a kernel body (lines 1-7) with a region; a helper (lines 9-11)
# whose body is another region, inlined twice, at lines 6 and 7
SOURCE_K = """void kernel() {
  K5_COUNT(R_TOP);
  x = 1;
  y = exp(x);
  z = h(y);
  w = h(z);
}

float h(float v) {
  { K5_COUNT(R_H, 4);
    return v + 1;
  }
}
"""


def test_parse_sass_reads_functions_opcodes_and_chains():
    instrs = opcount.parse_sass(SASS)
    assert [i.opcode for i in instrs] == [
        "LDC", "FMUL", "MUFU.EX2", "FADD", "FADD", "FADD", "MUFU.RCP", "EXIT",
        "FFMA", "RET.REL.NODEC", "EXIT"]
    assert instrs[0].function == "_Z6kernelv"
    assert instrs[-1].function == "_Z4halfv" and instrs[-1].chain == ()
    # one marker line per inline level, innermost first
    assert instrs[1].chain == (("math.h", 90), ("k.cu", 5))
    assert instrs[3].chain == (("k.cu", 12), ("k.cu", 6))
    assert [i.slow_path for i in instrs] == [False] * 8 + [True] * 2 + [False]
    assert [i.predicated for i in instrs] == [False, True] + [False] * 9


def test_attribute_and_dynamic_count():
    sites = opcount.probe_sites(SOURCE_K)
    assert sites["R_TOP"] == opcount.Site(1, 7, 1)
    assert sites["R_H"] == opcount.Site(10, 12, 4)
    assert opcount.function_block(SOURCE_K, "h") == opcount.Site(9, 13, 1)
    instrs = opcount.parse_sass(SASS)
    groups, lost = opcount.attribute(instrs, sites, "k.cu")
    # LDC and the inlined exp belong to the body; the helper's three FADDs
    # to R_H, in two copies (call lines 6 and 7); the RCP and the EXITs carry
    # no line of k.cu, and the slow path is not counted
    assert [g and g[0] for g in groups] == [
        "R_TOP"] * 3 + ["R_H"] * 3 + [None] * 5
    assert lost == 5
    per, static, copies, lost = opcount.region_tallies(instrs, sites, "k.cu")
    assert copies == {"R_TOP": 1, "R_H": 2} and lost == 5
    assert static == {"R_TOP": 3, "R_H": 1.5}
    # the FMUL is predicated: issued, but no operation
    assert per["R_TOP"] == opcount.Tally(3.0, 0.0, 1.0)
    assert per["R_H"] == opcount.Tally(1.5, 1.5, 0.0)
    dyn = opcount.dynamic_count(per, {"R_TOP": 10, "R_H": 80}, sites)
    # R_H: 1.5 instructions a copy, 80 counted iterations of a loop
    # unrolled 4 times
    assert dyn == {"R_TOP": opcount.Tally(30.0, 0.0, 10.0),
                   "R_H": opcount.Tally(30.0, 30.0, 0.0)}


def test_call_site_tally_takes_the_largest_copy():
    # R_H's copies hold one FADD (call line 6) and two (call line 7): a
    # region with one call site runs its main copy, not the mean of both
    instrs = opcount.parse_sass(SASS)
    sites = opcount.probe_sites(SOURCE_K)
    assert opcount.call_site_tally(instrs, sites, "k.cu", "R_H") == (
        opcount.Tally(2.0, 2.0, 0.0), 2)
    assert opcount.call_site_tally(instrs, sites, "k.cu", "R_TOP") == (
        opcount.Tally(3.0, 0.0, 1.0), 3)
    with pytest.raises(ValueError, match="no instruction of region R_X"):
        opcount.call_site_tally(instrs, {"R_X": opcount.Site(20, 21, 1)},
                                "k.cu", "R_X")


# a branch with two arms (lines 3 and 4), straight code (line 5) and a loop
# (line 6); then a guarded body (lines 12-13) whose load the compiler
# moved above the guard's branch and whose store below the join
SASS_BRANCHES = """
.text._Z1kv:
        //## File "/src/b.cu", line 2
        /*0000*/                   ISETP.GE.AND P0, PT, R0, 0x4, PT ;
        /*0010*/               @P0 BRA `(.L_x_1) ;
        //## File "/src/b.cu", line 3
        /*0020*/                   FMUL R1, R1, R2 ;
        /*0030*/                   FFMA R1, R1, R2, R3 ;
        /*0040*/                   MUFU.EX2 R1, R1 ;
        /*0050*/                   BRA `(.L_x_2) ;
.L_x_1:
        //## File "/src/b.cu", line 4
        /*0060*/                   FADD R1, R1, R2 ;
.L_x_2:
        //## File "/src/b.cu", line 5
        /*0070*/                   FADD R1, R1, R3 ;
        /*0080*/                   FADD R1, R1, R3 ;
        /*0090*/                   FADD R1, R1, R3 ;
        /*00a0*/                   FADD R1, R1, R3 ;
        /*00b0*/                   FADD R1, R1, R3 ;
.L_x_3:
        //## File "/src/b.cu", line 6
        /*00c0*/                   FADD R4, R4, R1 ;
        /*00d0*/               @P1 FMUL R4, R4, R4 ;
        /*00e0*/              @!P2 BRA `(.L_x_3) ;
        //## File "/src/b.cu", line 8
        /*00f0*/                   EXIT ;
.text._Z1gv:
        //## File "/src/b.cu", line 12
        /*0000*/                   LDG.E R1, desc[UR4][R2.64] ;
        //## File "/src/b.cu", line 11
        /*0010*/               @P3 BRA `(.L_x_9) ;
        //## File "/src/b.cu", line 13
        /*0020*/                   FMUL R1, R1, R1 ;
        /*0030*/                   FMUL R1, R1, R1 ;
        /*0040*/                   FADD R1, R1, R1 ;
.L_x_9:
        /*0050*/                   STG.E desc[UR4][R2.64], R1 ;
        //## File "/src/b.cu", line 15
        /*0060*/                   EXIT ;
"""
SOURCE_B = """void k() { K5_COUNT(R_TOP);
  if (c) {
    a;
  } else { b; }
  x;
  for (;;) { K5_COUNT(R_IT);
  }
}

void g() {
  if (active) {
    K5_COUNT(R_G); a = load;
    b = f(a);
  }
}
"""


def test_least_paths_take_the_cheaper_arm_and_one_loop_pass():
    instrs = opcount.parse_sass(SASS_BRANCHES)
    assert instrs[1].target == ".L_x_1" and instrs[6].labels == (".L_x_1",)
    assert instrs[12].labels == (".L_x_3",) and instrs[14].predicated
    sites = opcount.probe_sites(SOURCE_B)
    assert sites == {"R_TOP": opcount.Site(1, 8, 1),
                     "R_IT": opcount.Site(6, 7, 1),
                     "R_G": opcount.Site(11, 14, 1)}
    groups, lost = opcount.attribute(instrs, sites, "b.cu")
    assert lost == 1     # g's EXIT
    # R_TOP skips the three-instruction arm for the one-instruction one and
    # runs its straight code; the loop body (R_IT) is crossed once; R_G
    # runs its body, which holds its largest block, and not the guard's
    # branch around it
    assert opcount.least_paths(instrs, groups) == (
        [True, True] + [False] * 4 + [True] * 10 + [True] * 6 + [False])
    per, static, copies, _ = opcount.region_tallies(instrs, sites, "b.cu")
    assert static == {"R_TOP": 13, "R_IT": 3, "R_G": 6}
    assert per["R_TOP"] == opcount.Tally(9.0, 6.0, 0.0)
    assert per["R_IT"] == opcount.Tally(3.0, 1.0, 0.0)
    assert per["R_G"] == opcount.Tally(6.0, 3.0, 0.0)
    dyn = opcount.dynamic_count(per, {"R_TOP": 10, "R_IT": 40}, sites)
    assert dyn["R_IT"] == opcount.Tally(120.0, 40.0, 0.0)
    assert dyn["R_G"] == opcount.Tally()


def test_function_block_rejects_a_missing_definition():
    with pytest.raises(ValueError, match="no definition of g"):
        opcount.function_block("float g(float);\nvoid f() {}\n", "g")


PTXAS = """ptxas info    : 0 bytes gmem
ptxas info    : Function properties for _Z8logLdivNv
    24 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Compiling entry function '_Z12solve_kernelv' for 'sm_90a'
ptxas info    : Function properties for _Z12solve_kernelv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, 416 bytes cmem[0]
"""


def test_ptxas_report():
    report = _build.ptxas_report(PTXAS)
    assert report["_Z12solve_kernelv"] == dict(
        registers=128, stack=0, spill_stores=0, spill_loads=0)
    assert report["_Z8logLdivNv"] == dict(stack=24, spill_stores=8,
                                          spill_loads=8)
