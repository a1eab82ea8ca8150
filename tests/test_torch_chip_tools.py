"""The readings that ``chip_smoke.py`` and ``chip_profile.py sass`` take from
a build: each kernel's registers and spills from ptxas's lines, and the
blocks an SM holds of it.  Pure Python: runs on the CPU."""

import chip_smoke

# nvcc's names of two kernels in an anonymous namespace, as ptxas prints them
K5 = "_ZN41_GLOBAL__N__1a2b3c4d_17_fused_adaptive_cu_5e6f7a8b17adaptive_fwd_rowsILi24EEEvPKfS2_"
REPLAY = "_ZN41_GLOBAL__N__1a2b3c4d_21_fused_adaptive_bwd_cu_5e6f7a8b15adaptive_replayILi12EEEvPKf"
LOG = f"""ptxas info    : Compiling entry function '{K5}' for 'sm_90a'
ptxas info    : Function properties for {K5}
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '{REPLAY}' for 'sm_90a'
ptxas info    : Function properties for {REPLAY}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 560 bytes cmem[0]
"""


def test_ptxas_usage_reads_registers_and_spills():
    assert chip_smoke.ptxas_usage(LOG) == {
        "adaptive_fwd_rows<24>": dict(registers=128, spill_stores=4, spill_loads=8),
        "adaptive_replay<12>": dict(registers=96, spill_stores=0, spill_loads=0)}
    assert chip_smoke.ptxas_usage("") == {}


def test_resident_blocks_follow_registers_and_shared_memory():
    # K5 at the flagship: 128-thread groups of 52,004 B; 4 fit at 128 registers
    assert chip_smoke.resident_blocks(128, 128, 52_004) == (4, 4, 4)
    # past 128 registers a thread, the registers allow 3
    assert chip_smoke.resident_blocks(168, 128, 52_004) == (3, 3, 4)
    # K3's row kernel: 256 threads, 39,668 B
    assert chip_smoke.resident_blocks(128, 256, 39_668) == (2, 2, 5)


def test_kernel_label_reads_a_namespace_by_its_length():
    # nvcc's name of K3's row kernel from a build where the anonymous
    # namespace's name ends in a word, not in 8 hex digits
    k3 = ("_ZN47_GLOBAL__N__a743282b_14_fused_solve_cu_cnf_plan20fused_solve_rk4_rows"
          "ILi32ELb0EEEvPKfS2_S2_N3cnf7WeightsENS3_4DimsES2_S2_Pfiiiii")
    assert chip_smoke.kernel_label(k3) == "fused_solve_rk4_rows<32, 0>"
    assert chip_smoke.kernel_label(K5) == "adaptive_fwd_rows<24>"
