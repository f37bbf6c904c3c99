"""The LM zoo trained on the card (``chip_smoke.py`` phase 37 as tests,
through ``repro_torch.launch.lm_train_smoke``): every preset reduced, one
2-microbatch train step on the card against the same step on the CPU
(nemotron-4-340b and arctic-480b with bf16 accumulation and AdamW state)
and remat against none; the token stream the same on the card as on the
CPU; qwen2-1.5b and hymba-1.5b at full width (the float64 oracle, the
loss falling over 7 steps); the train CLI at full width. Every test needs
an NVIDIA GPU (marker ``gpu``) and skips without one; on the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_lm_train_gpu.py
"""
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import tokens
from repro_torch.launch import lm_train_smoke
from repro_torch.launch import train as cli

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


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_step_on_the_card_matches_the_cpu(cuda, arch):
    out = lm_train_smoke.reduced_check(arch, cuda)
    assert set(out) == {"vs_cpu", "remat"}


def test_token_batch_is_the_same_on_the_card(cuda):
    a = tokens.token_batch(3, 2, 4, 64, 151936, device=cuda)
    b = tokens.token_batch(3, 2, 4, 64, 151936)
    for k in ("tokens", "labels"):
        assert a[k].device.type == "cuda"
        assert torch.equal(a[k].cpu(), b[k])


@pytest.mark.parametrize("arch", lm_train_smoke.FULL_WIDTH)
def test_full_width_trains_against_the_float64_oracle(cuda, arch):
    out = lm_train_smoke.full_width_check(get_config(arch), cuda)
    for dt in ("f32", "bf16"):
        assert out[dt]["loss_after"] < out[dt]["losses"][0]
        assert 0 < out[dt]["idle_share"] < 1


def test_cli_trains_at_full_width(cuda):
    out = cli.run(cli.build_parser().parse_args(
        ["--arch", "qwen2-1.5b", "--steps", "2", "--batch", "1", "--seq",
         "512", "--dtype", "bf16"]))
    assert out["final_step"] == 2 and len(out["history"]) == 2
