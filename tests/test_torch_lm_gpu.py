"""The LM zoo served on the card (``chip_smoke.py`` phase 36 as tests,
through ``repro_torch.launch.lm_smoke``): qwen2-1.5b and hymba-1.5b at
full width, f32 (TF32 off) and bf16, decode against ``forward`` and the
served prefill and greedy decode; ``multihead_attention`` at their
prefill shapes against a dense masked softmax; every preset reduced; the
serve CLI at full width. Every test needs an NVIDIA GPU (marker ``gpu``)
and skips without one; on the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_lm_gpu.py
"""
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import lm_smoke
from repro_torch.launch import serve as cli

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """The card, with TF32 off; skips without one (decided here, never at
    import, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA; run this file on the "
                    "card with `python -m pytest -m gpu`")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


@pytest.mark.parametrize("arch", lm_smoke.FULL_WIDTH)
def test_full_width_decode_matches_forward_and_serves(cuda, arch):
    out = lm_smoke.serve_check(get_config(arch), cuda)
    assert set(out) == {"f64", "f32", "bf16"}
    for r in (out["f32"], out["bf16"]):
        assert len(r["tokens_row0"]) == lm_smoke.NEW + 1
        assert r["decode_bound_ms"] > 0 and r["decode_ms_per_token"] > 0
        assert 0 < r["decode_busy_ms_per_token"]
    f32 = out["f32"]
    assert (f32["decode_vs_f64_max_abs"]
            <= lm_smoke.BF16_FACTOR * f32["forward_vs_f64_max_abs"])
    if not get_config(arch).has_ssm:  # lm_smoke.F32_TOL says why
        assert f32["allclose_excess"] <= 0
    assert (out["bf16"]["decode_vs_forward_max_abs"]
            <= lm_smoke.BF16_FACTOR
            * out["bf16"]["bf16_vs_f32_forward_max_abs"])


@pytest.mark.parametrize("arch", lm_smoke.FULL_WIDTH)
def test_attention_at_the_prefill_shape(cuda, arch):
    cfg = get_config(arch)
    a = lm_smoke.attention_check(cfg, cuda, lm_smoke.BATCH, lm_smoke.PROMPT)
    assert a["scaled_err"] <= lm_smoke.ATTN_TOL
    assert a["window"] == (0 if arch == "qwen2-1.5b" else cfg.window_size)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_preset_on_the_card(cuda, arch):
    lm_smoke.reduced_check(arch, cuda)


def test_cli_serves_qwen2_at_full_width(cuda):
    out = cli.main(["--arch", "qwen2-1.5b", "--new-tokens", "8"])
    assert out is None  # main prints; run() returns the numbers
    res = cli.run(cli.build_parser().parse_args(
        ["--arch", "qwen2-1.5b", "--dtype", "bf16", "--new-tokens", "8"]))
    assert res["device"] == torch.cuda.get_device_name(cuda)
    assert len(res["tokens"]) == 4 and len(res["tokens"][0]) == 8
