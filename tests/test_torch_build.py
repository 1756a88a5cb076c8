"""salsa_tpu_torch.kernels.build: the readers of the compilers' output that
`chip_smoke.py` holds the kernels to (ptxas registers, spills and serialized
wgmma pipelines, SASS opcodes), on fixed snippets in the formats of `nvcc
-Xptxas -v` and `cuobjdump -sass`."""
import pytest

pytest.importorskip("torch")

from salsa_tpu_torch.kernels import build  # noqa: E402

MMA = "_ZN12_GLOBAL__N_121conv3x3_64_mma_kernelILi8EEEvPK13__nv_bfloat16S3_PS1_iiii"
F32 = "_ZN12_GLOBAL__N_121conv3x3_64_f32_kernelILi8EEEvPKfS2_Pfiii"
WGMMA = ("_ZN12_GLOBAL__N_123conv3x3_64_wgmma_kernelILi2EEEv14CUtensorMap_stS1_PK13__nv_"
         "bfloat16S4_iiiiii")

SASS = f"""
Fatbin elf code:
================
arch = sm_90a
code version = [1,8]
host = linux
compile_size = 64bit

	code for sm_90a
		Function : {MMA}
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                                     /* 0x00000a00ff017b82 */
                                                                                              /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                                         /* 0x0000000000007919 */
        /*0020*/              @!P0 BRA 0x1d0 ;                                                /* 0x0000000000608947 */
        /*0030*/                   LDS R8, [R3+UR4] ;                                         /* 0x0000000403087984 */
        /*0040*/                   HMMA.16816.F32.BF16 R24, R4, R20, R24 ;                    /* 0x000000140418723c */
        /*0050*/                   HMMA.16816.F32.BF16 R28, R8, R20, R28 ;                    /* 0x00000014081c723c */
        /*0060*/               @P1 STG.E [R6.64], R9 ;                                        /* 0x0000000906001986 */
        /*0070*/                   EXIT ;                                                     /* 0x000000000000794d */
        /*0080*/                   BRA 0x80;                                                  /* 0xfffffffc00fc7947 */
		..........

		Function : {F32}
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                                     /* 0x00000a00ff017b82 */
        /*0010*/                   FFMA R2, R4, R5, R2 ;                                      /* 0x0000000504027223 */
        /*0020*/                   FFMA R3, R4, R6, R3 ;                                      /* 0x0000000604037223 */
        /*0030*/              @!UPT UIADD3 UR4, UR4, 0x1, URZ ;                               /* 0x0000000104047890 */
        /*0040*/                   EXIT ;                                                     /* 0x000000000000794d */
		..........
"""

PTXAS = f"""ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{MMA}' for 'sm_90a'
ptxas info    : Function properties for {MMA}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 154 registers, used 0 barriers, 396 bytes cmem[0]
ptxas info    : Compiling entry function '{F32}' for 'sm_90a'
ptxas info    : Function properties for {F32}
    24 bytes stack frame, 20 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 392 bytes cmem[0]
"""

# the persistent bf16 K4: TMA loads, mbarriers, ldmatrix, wgmma, 16-byte stores
SASS_WGMMA = f"""
	code for sm_90a
		Function : {WGMMA}
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                                     /* 0x00000a00ff017b82 */
        /*0010*/                   UTMALDG.4D [UR8], [UR14] ;                                 /* 0x00000008080075b4 */
        /*0020*/                   SYNCS.ARRIVE.TRANS64.RED.A1T0 RZ, [UR4+0x8], RZ ;          /* 0x000008ffffff79a7 */
        /*0030*/                   LDSM.16.M88.4 R24, [R3+UR4] ;                              /* 0x000000040318783b */
        /*0040*/                   WARPGROUP.ARRIVE ;                                         /* 0x00000000000079c8 */
        /*0050*/                   HGMMA.64x64x16.F32.BF16 R88, R24, gdesc[UR8], R88 ;       /* 0x08e00008185879f0 */
        /*0060*/                   HGMMA.64x64x16.F32.BF16 R88, R28, gdesc[UR12], R88, gsb0 ; /* 0x08e000081c5879f0 */
        /*0070*/                   WARPGROUP.DEPBAR.LE gsb0, 0x1 ;                            /* 0x00000000000079c8 */
        /*0080*/               @!P0 STG.E.128 desc[UR6][R2.64], R8 ;                          /* 0x0000000802008986 */
        /*0090*/                   EXIT ;                                                     /* 0x000000000000794d */
		..........
"""

PTXAS_WGMMA = f"""ptxas info    : Compiling entry function '{WGMMA}' for 'sm_90a'
ptxas info    : Function properties for {WGMMA}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 512 bytes cmem[0]
"""
SERIALIZED = ("ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async "
              "instructions are serialized due to the presence of Extern calls in the "
              f"function '{WGMMA}'.")
# the same note, naming no kernel: it belongs to the kernel compiled last
SERIALIZED_UNNAMED = ("ptxas info    : (C7510) Potential Performance Loss: wgmma.mma_async "
                      "instructions are serialized due to insufficient register resources for "
                      "the wgmma pipeline")


def test_sass_opcode_counts_reads_each_kernel():
    ops = build.sass_opcode_counts(SASS)
    assert set(ops) == {MMA, F32}
    assert ops[MMA] == {"LDC": 1, "S2R": 1, "BRA": 2, "LDS": 1, "HMMA": 2, "STG": 1,
                        "EXIT": 1}
    assert ops[F32] == {"LDC": 1, "FFMA": 2, "UIADD3": 1, "EXIT": 1}
    assert "HMMA" not in ops[F32]


def test_sass_opcode_counts_skips_encodings_and_headers():
    # the encoding words (/* 0x... */) and the header lines are not instructions
    ops = build.sass_opcode_counts(SASS)
    assert sum(ops[MMA].values()) == 9 and sum(ops[F32].values()) == 5
    assert build.sass_opcode_counts("") == {}
    assert build.sass_opcode_counts(SASS.split("\t\tFunction")[0]) == {}


def test_ptxas_usage_reads_registers_and_spills():
    assert build.ptxas_usage(PTXAS) == {MMA: (154, 0, 0), F32: (128, 20, 16)}


def test_cuda_tools_are_looked_up_not_assumed(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="cuobjdump not found"):
        build.library_sass(tmp_path / "lib.so")
    tool = tmp_path / "bin" / "cuobjdump"
    tool.parent.mkdir()
    tool.write_text("")
    assert build._find_tool("cuobjdump") == str(tool)


def test_variant_builds_need_nvcc(monkeypatch, tmp_path):
    """Side-by-side builds look nvcc up as the library build does, and raise where
    there is none."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_variants({"tree": (build.CSRC_DIR / "salsa_spatial.cu", [])}, "variants",
                             "salsa_spatial_launch")


@pytest.mark.parametrize("sass, kernel, want", [
    (SASS, MMA, {"HMMA": 2, "LDS": 1}),
    (SASS_WGMMA, WGMMA, {"HGMMA": 2, "UTMALDG": 1, "STG": 1, "LDSM": 1, "SYNCS": 1,
                         "WARPGROUP": 2}),
])
def test_sass_opcode_counts_reads_tensor_core_and_tma_opcodes(sass, kernel, want):
    """mma.sync's HMMA, wgmma's HGMMA and TMA's UTMALDG, predicated or not, are
    read without their modifiers: what phase 1 holds K4's kernels to."""
    ops = build.sass_opcode_counts(sass)[kernel]
    assert {k: ops.get(k, 0) for k in want} == want
    assert "HGMMA" not in build.sass_opcode_counts(SASS)[F32]


@pytest.mark.parametrize("log, want", [
    (PTXAS, {}),
    (PTXAS_WGMMA, {}),
    (PTXAS_WGMMA + SERIALIZED + "\n", {WGMMA: SERIALIZED}),
    (PTXAS_WGMMA + SERIALIZED_UNNAMED + "\n" + PTXAS, {WGMMA: SERIALIZED_UNNAMED}),
])
def test_wgmma_serialized_reads_ptxas_notes(log, want):
    """The parser phase 1 fails on: a kernel whose wgmma pipeline ptxas
    serialized, by the name in the note or else the kernel compiled last; a log
    without the note gives none. Registers and spills still read as before."""
    assert build.wgmma_serialized(log) == want
    if log.startswith(PTXAS_WGMMA):
        assert build.ptxas_usage(log)[WGMMA] == (168, 0, 0)
