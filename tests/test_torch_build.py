"""The port's build report and repeatability helpers, on the CPU.

- ``ops._build.ptxas_report`` on canned ``nvcc -Xptxas -v`` logs in the
  format ptxas 12.8 prints for sm_90a: a clean kernel, one that spills, the
  C7512/C7515 note that a kernel's wgmmas are serialized (before or after
  the kernel's entry line), and a log that names the d = 32, 64 and 128
  instantiations of both backward kernels (the registers and spills of the
  tree before the d = 128 redesign);
- a built library's saved log comes back from ``build`` without nvcc;
- ``utils.determinism.differences`` on CPU tensors, and the train and
  evaluation entry points pinning cuDNN's deterministic algorithms while
  their CPU results stay what they were.
"""

import copy

import pytest
import torch

from causaldiffae_torch.ops import _build
from causaldiffae_torch.utils import determinism

NS = "_ZN4cdae49_GLOBAL__N__7dabbc59_16_attention_bwd_cu_ff0197bd"
DKV = "24attention_bwd_dkv_kernelILi{d}EEEv14CUtensorMap_stS2_PK13__nv_bfloat16PKfS7_PS3_iixxxxf"
DQ = "23attention_bwd_dq_kernelILi{d}EEEv14CUtensorMap_stPK13__nv_bfloat16S5_S5_PKfPS3_Pfiixxxxxxxxf"
FWD = ("_ZN4cdae49_GLOBAL__N__e63afe4f_16_attention_fwd_cu_f8083f6120attention_fwd_kernelILi{d}EEEv"
       "14CUtensorMap_stPK13__nv_bfloat16PS3_Pfixxxxf")


def entry(mangled, registers, spill=0, smem=32):
    """ptxas's lines for one kernel, as ``-Xptxas -v`` prints them."""
    stack = f"{spill} bytes cumulative stack size, " if spill else ""
    return (f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {mangled}\n"
            f"    {spill} bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
            f"ptxas info    : Used {registers} registers, used 1 barriers, {stack}{smem} bytes smem\n"
            "ptxas info    : Compile time = 113.901 ms\n")


def serialized(mangled, word="for"):
    return ("ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async instructions are "
            f"serialized due to insufficient register resources {word} the function '{mangled}'\n")


def test_ptxas_report_reads_a_clean_kernel():
    (rec,) = _build.ptxas_report("ptxas info    : 0 bytes gmem\n" + entry(FWD.format(d=32), 94))
    assert rec == {"name": "cdae::(anonymous namespace)::attention_fwd_kernel<32>",
                   "kernel": "attention_fwd_kernel", "d": 32, "registers": 94,
                   "spill_stores": 0, "spill_loads": 0, "stack": 0, "smem_static": 32,
                   "wgmma_serialized": False, "serialized_reason": None}


def test_ptxas_report_reads_spills():
    log = entry(FWD.format(d=64), 123) + entry(NS + DKV.format(d=128), 255, spill=160)
    clean, spilled = _build.ptxas_report(log)
    assert (clean["d"], clean["spill_stores"], clean["spill_loads"]) == (64, 0, 0)
    assert (spilled["kernel"], spilled["d"], spilled["registers"]) == \
        ("attention_bwd_dkv_kernel", 128, 255)
    assert (spilled["spill_stores"], spilled["spill_loads"], spilled["stack"],
            spilled["smem_static"]) == (160, 160, 160, 32)


@pytest.mark.parametrize("where", ["before", "after"])
@pytest.mark.parametrize("word", ["for", "in"])
def test_ptxas_report_reads_the_wgmma_serialization_note(where, word):
    """ptxas 12.8 prints the note before the kernel's entry line and names
    the kernel; it is held to the kernel it names, not to its neighbour."""
    dkv, dq = NS + DKV.format(d=128), NS + DQ.format(d=128)
    note = serialized(dkv, word)
    body = entry(dkv, 255, spill=160) + entry(dq, 218)
    recs = _build.ptxas_report(note + body if where == "before" else entry(dkv, 255, 160) + note
                               + entry(dq, 218))
    assert [(r["kernel"], r["wgmma_serialized"]) for r in recs] == \
        [("attention_bwd_dkv_kernel", True), ("attention_bwd_dq_kernel", False)]
    assert recs[0]["serialized_reason"] == "insufficient register resources"


def test_ptxas_report_names_every_backward_instantiation():
    """The backward library's log as the tree before the d = 128 redesign
    built it: both kernels at d = 32, 64 and 128, in the log's order."""
    log = (serialized(NS + DKV.format(d=128)) + "ptxas info    : 0 bytes gmem\n"
           + entry(NS + DKV.format(d=128), 255, spill=160) + entry(NS + DQ.format(d=128), 218)
           + entry(NS + DKV.format(d=64), 207) + entry(NS + DQ.format(d=64), 154)
           + entry(NS + DKV.format(d=32), 154) + entry(NS + DQ.format(d=32), 122))
    recs = _build.ptxas_report(log)
    assert [(r["kernel"], r["d"], r["registers"], r["spill_stores"], r["wgmma_serialized"])
            for r in recs] == [
        ("attention_bwd_dkv_kernel", 128, 255, 160, True),
        ("attention_bwd_dq_kernel", 128, 218, 0, False),
        ("attention_bwd_dkv_kernel", 64, 207, 0, False),
        ("attention_bwd_dq_kernel", 64, 154, 0, False),
        ("attention_bwd_dkv_kernel", 32, 154, 0, False),
        ("attention_bwd_dq_kernel", 32, 122, 0, False)]
    assert {r["name"] for r in recs if r["d"] == 64} == {
        "cdae::(anonymous namespace)::attention_bwd_dkv_kernel<64>",
        "cdae::(anonymous namespace)::attention_bwd_dq_kernel<64>"}


@pytest.mark.parametrize("mangled,want", [
    ("_ZN4cdae12_GLOBAL__N_120attention_fwd_kernelILi128EEEvPKf",
     ("cdae::(anonymous namespace)::attention_fwd_kernel<128>", 128)),
    ("_ZN3foo3barEv", ("foo::bar", None)),
    ("_Z6squarei", ("_Z6squarei", None)),
    ("kernel_in_c", ("kernel_in_c", None)),
])
def test_demangle(mangled, want):
    assert _build._demangle(mangled) == want


def test_build_returns_the_saved_log_of_a_built_library(tmp_path, monkeypatch):
    """An up-to-date library is not rebuilt (no nvcc here), and its build
    report still reads: ``build`` hands back the log saved beside it."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    lib = _build._lib_path("attention_fwd")
    lib.write_bytes(b"")
    assert _build.build("attention_fwd") == (0.0, "")
    log = entry(FWD.format(d=128), 168)
    lib.with_suffix(".log").write_text(log)
    seconds, got = _build.build("attention_fwd")
    assert seconds == 0.0 and [r["registers"] for r in _build.ptxas_report(got)] == [168]


def _state():
    g = torch.Generator().manual_seed(0)
    return {"model": {"w": torch.randn(3, 4, generator=g), "n": torch.tensor([float("nan"), 1.0])},
            "optimizer": {"state": {0: {"step": torch.tensor(2.0),
                                        "exp_avg": torch.randn(3, 4, generator=g)}},
                          "param_groups": [{"lr": 1e-4}]},
            "ema": {"0.9999": {"w": torch.randn(3, 4, generator=g).to(torch.bfloat16)}},
            "step": 2}


@pytest.mark.parametrize("change,want", [
    (None, {}),
    (lambda s: s["model"]["w"].__setitem__((1, 2), s["model"]["w"][1, 2] + 2 ** -10),
     {"/model/w": 2 ** -10}),
    (lambda s: s["ema"]["0.9999"].__setitem__("w", s["ema"]["0.9999"]["w"].float()),
     {"/ema/0.9999/w": float("inf")}),
    (lambda s: s["optimizer"]["state"][0]["step"].add_(1), {"/optimizer/state/0/step": 1.0}),
    (lambda s: s.__setitem__("step", 3), {}),   # not a tensor: not compared
])
def test_differences_compares_bit_for_bit(change, want):
    a = _state()
    b = copy.deepcopy(a)
    if change is not None:
        change(b)
    got = determinism.differences(a, b)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-3)


def test_differences_sees_one_ulp_and_signed_zero():
    a = {"x": torch.tensor([1.0, 0.0])}
    assert determinism.differences(a, {"x": torch.tensor([1.0 + 2 ** -23, 0.0])}) == \
        {"/x": pytest.approx(2 ** -23)}
    assert determinism.differences(a, {"x": torch.tensor([1.0, -0.0])}) == {"/x": 0.0}


def test_differences_raises_on_states_of_other_tensors():
    with pytest.raises(KeyError):
        determinism.differences({"a": torch.zeros(1)}, {"b": torch.zeros(1)})


def _tiny_cfg():
    from causaldiffae_torch.config import Config

    return Config(name="tiny", dataset="morphomnist", image_size=28, in_channels=1,
                  num_channels=32, num_res_blocks=1, num_heads=2, n_vars=2, rep_dim=16,
                  attention_resolutions="7", class_cond=True, rep_cond=True,
                  causal_modeling=True, masking=True, diffusion_steps=20, batch_size=2,
                  log_interval=1, save_interval=1, kl_anneal_steps=5, use_bf16=False)


@pytest.fixture
def cudnn_unpinned(monkeypatch):
    """cuDNN's flags as a fresh process has them; restored afterwards."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)


def test_train_cli_pins_cudnn_and_leaves_cpu_results_as_they_were(tmp_path, monkeypatch,
                                                                   cudnn_unpinned):
    """The train CLI holds cuDNN to deterministic algorithms; on the CPU its
    checkpoint is bit-equal to a run without the pin."""
    from causaldiffae_torch import train
    from causaldiffae_torch.training import CheckpointManager

    monkeypatch.setattr(train, "get_config", lambda name: _tiny_cfg())

    def run(tag):
        train.main(["--synthetic", "--device", "cpu", "--total_steps", "2",
                    "--ckpt_dir", str(tmp_path / tag)])
        return CheckpointManager(str(tmp_path / tag)).load()

    with monkeypatch.context() as m:
        m.setattr(determinism, "pin", lambda: None)
        unpinned = run("unpinned")
    assert torch.backends.cudnn.deterministic is False
    pinned = run("pinned")
    assert torch.backends.cudnn.deterministic is True
    assert torch.backends.cudnn.benchmark is False
    assert determinism.differences(unpinned, pinned) == {}


def test_evaluation_start_pins_cudnn(cudnn_unpinned):
    from causaldiffae_torch.evals import cli

    cli.start("cpu")
    assert torch.backends.cudnn.deterministic is True
    assert torch.backends.cudnn.benchmark is False
