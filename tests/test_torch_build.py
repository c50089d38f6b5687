"""edl_tpu_torch.ops._build.ptxas_info on a canned ptxas report: needs no
nvcc and no card."""

from edl_tpu_torch.ops import _build

_DKV = ("_ZN45_GLOBAL__N__da1476e7_12_flash_bwd_cu_b47bff4c20flash_bwd_dkv_"
        "kernelILi128ELb1EEEv14CUtensorMap_stS1_S1_S1_S1_S1_NS_6ParamsE")
_DQ = ("_ZN45_GLOBAL__N__da1476e7_12_flash_bwd_cu_b47bff4c19flash_bwd_dq_"
       "kernelILi64ELb0EEEv14CUtensorMap_stS1_S1_S1_S1_NS_6ParamsE")

# two instantiations as `nvcc -Xptxas -v` reports them: the first spills,
# the second draws a wgmma serialization warning before its own entry
REPORT = f"""\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{_DKV}' for 'sm_90a'
ptxas info    : Function properties for {_DKV}
    16 bytes stack frame, 16 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers, 16 bytes cumulative stack size
ptxas info    : Compile time = 329.402 ms
ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions are serialized due to the presence of Extern calls in the function '{_DQ}'.
ptxas info    : Compiling entry function '{_DQ}' for 'sm_90a'
ptxas info    : Function properties for {_DQ}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 154 registers, used 16 barriers
ptxas info    : Compile time = 154.569 ms
"""


def _canned(monkeypatch, tmp_path, text):
    lib = tmp_path / "flash_bwd-0123456789abcdef.so"
    (tmp_path / "flash_bwd-0123456789abcdef.ptxas.txt").write_text(text)
    monkeypatch.setattr(_build, "library_path", lambda name: str(lib))


def test_ptxas_info_reads_registers_spills_and_serialization(monkeypatch,
                                                            tmp_path):
    _canned(monkeypatch, tmp_path, REPORT)
    assert _build.ptxas_info("flash_bwd") == {
        "flash_bwd_dkv<128,1>": {"registers": 168, "spill_bytes": 28,
                                 "wgmma_serialized": False},
        "flash_bwd_dq<64,0>": {"registers": 154, "spill_bytes": 0,
                               "wgmma_serialized": True},
    }


def test_ptxas_info_unnamed_warning_belongs_to_the_current_kernel(
        monkeypatch, tmp_path):
    """A C75xx line that names no function marks the kernel being
    compiled; warnings outside C7510-C7520 mark nothing."""
    text = REPORT.replace(f" in the function '{_DQ}'", "") + (
        "ptxas info    : (C7509) Potential Performance Loss: something else\n")
    _canned(monkeypatch, tmp_path, text)
    info = _build.ptxas_info("flash_bwd")
    assert info["flash_bwd_dkv<128,1>"]["wgmma_serialized"] is True
    assert info["flash_bwd_dq<64,0>"]["wgmma_serialized"] is False
