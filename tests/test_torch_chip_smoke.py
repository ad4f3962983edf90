"""The chip run's own bookkeeping of kernel 8's route, on the CPU.

``chip_smoke.py`` holds, on the card, that kernel 8 is built at every head
dim and that its launches ran the kernel its C entry point's route picks
(phases 2, 9, 9b and 7), and ``tools/flash_variants.py`` times modified
copies of the kernel's source. Both restate parts of
``csrc/flash_attention.cu``; these tests hold the restatements against the
source text, and the parsers against the report formats the card's tools
print (``ptxas -v``, torch.profiler's kernel names), so that a change of
the source cannot leave the chip run checking the wrong thing.
"""

import importlib.util
import pathlib
import re

import pytest

from repro_torch.kernels.flash_attention.ops import HEAD_DIMS

REPO = pathlib.Path(__file__).resolve().parents[1]
SOURCE = (REPO / "src" / "repro_torch" / "kernels" / "csrc" / "flash_attention.cu").read_text()


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load("chip_smoke", REPO / "chip_smoke.py")

# a ptxas -v report of the flash library in the form nvcc prints it on the
# card (only the wgmma kernel's entries)
PTXAS = "\n".join(
    f"ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__e7510225_18_flash_attention_"
    f"cu_2c13897928flash_attention_wgmma_kernelILi{d}EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16"
    f"NS_7ProblemE' for 'sm_90a'\n"
    f"ptxas info    : Function properties for x\n"
    f"    0 bytes stack frame, 0 bytes spill stores, {spill} bytes spill loads\n"
    f"ptxas info    : Used 168 registers, used 1 barriers"
    for d, spill in ((128, 0), (80, 0), (64, 0), (32, 8)))


def test_route_restatement_matches_the_entry_point():
    """The wgmma kernel takes a bf16 call with a whole 128-query tile and a
    key, at every head dim the op takes; the mma.sync kernel the rest."""
    assert re.search(r"constexpr int kWQ = (\d+);", SOURCE).group(1) == str(cs.FLASH_WGMMA_SQ)
    launch = SOURCE[SOURCE.index("int launch(const void* q"):]
    launch = launch[:launch.index("\n}\n")]
    assert "if constexpr (!kF32) {" in launch
    assert "if (p.sq >= kWQ && p.sk >= 1) return launch_wgmma<D>(" in launch
    dispatched = sorted(int(d) for d in re.findall(r"case (\d+): return launch<T, \1>", SOURCE))
    assert dispatched == sorted(HEAD_DIMS)


@pytest.mark.parametrize("shape, want", [
    ((4, 16, 16, 2048, 2048, 80, 0, -1, 0, 1), "flash_attention_wgmma_kernel<80>"),
    ((2, 4, 4, 128, 128, 32, 1, -1, 0, 1), "flash_attention_wgmma_kernel<32>"),
    ((1, 4, 4, 127, 2048, 80, 1, 64, 0, 1), "flash_attention_bf16_kernel<80>"),
    ((4, 24, 8, 1, 2049, 64, 1, -1, 2048, 1), "flash_attention_bf16_kernel<64>"),
    ((1, 4, 4, 300, 0, 128, 0, -1, 0, 1), "flash_attention_bf16_kernel<128>"),
    ((4, 4, 4, 256, 256, 80, 1, -1, 0, 0), "flash_attention_fp32_kernel<80>"),
])
def test_flash_kernel_name(shape, want):
    assert cs.flash_kernel_name(shape) == want
    assert want.split("<")[0] in SOURCE


def test_ptxas_report_names_every_wgmma_instantiation():
    entries = [dict(kernel=k, registers=r, spill_stores=ss, spill_loads=sl)
               for k, r, ss, sl in cs.ptxas_entries(PTXAS)]
    assert cs.wgmma_head_dims(entries) == [32, 64, 80, 128]
    assert [cs.short_kernel_name(e["kernel"]) for e in entries] == [
        f"flash_attention_wgmma_kernel<{d}>" for d in (128, 80, 64, 32)]
    assert [e["spill_loads"] for e in entries] == [0, 0, 0, 8]
    assert cs.short_kernel_name("_Z18gather_rows_kernelPKfPf") == "_Z18gather_rows_kernelPKfPf"


def test_profiler_names_count_by_kernel():
    events = [("void (anonymous namespace)::flash_attention_wgmma_kernel<80>(CUtensorMap_st, "
               "CUtensorMap_st, CUtensorMap_st, __nv_bfloat16*, (anonymous namespace)::Problem)",
               47),
              ("void (anonymous namespace)::flash_attention_wgmma_kernel<80>(CUtensorMap_st)", 1),
              ("void (anonymous namespace)::flash_attention_bf16_kernel<80>(__nv_bfloat16 "
               "const*, __nv_bfloat16 const*)", 2),
              ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", 96)]
    assert cs.flash_kernel_counts(events) == {"flash_attention_wgmma_kernel<80>": 48,
                                              "flash_attention_bf16_kernel<80>": 2}


def test_flash_variants_find_their_anchors():
    """Each of the tool's copies changes the source where it says."""
    tool = _load("flash_variants", REPO / "tools" / "flash_variants.py")
    copies = tool.variants(SOURCE)
    assert set(copies) == {"no_exp", "no_pv", "no_qk", "loads_only", "stages3"}
    assert "#define exp2f(x) (x)" in copies["no_exp"] and tool.QK in copies["no_exp"]
    assert tool.PV not in copies["no_pv"] and tool.QK in copies["no_pv"]
    assert tool.QK not in copies["no_qk"] and tool.PV in copies["no_qk"]
    assert tool.QK not in copies["loads_only"] and tool.PV not in copies["loads_only"]
    assert "constexpr int kStages = 3;" in copies["stages3"]


def test_hold_flash_route_keeps_what_the_prefill_ran(monkeypatch):
    monkeypatch.setattr(cs, "FLASH_ROUTES", {})
    shape = (4, 16, 16, 2048, 2048, 80, 0, -1, 0, 1)
    wgmma = "flash_attention_wgmma_kernel<80>"
    cs.hold_flash_route("hubert", {wgmma: 48}, {shape: 48})
    assert cs.FLASH_ROUTES == {shape: wgmma}
    for ran in ({"flash_attention_bf16_kernel<80>": 48}, {wgmma: 47}, {}):
        with pytest.raises(cs.SmokeFailure):
            cs.hold_flash_route("hubert", ran, {shape: 48})
    cs.hold_flash_route("mamba2", {}, {})  # no attention layer
