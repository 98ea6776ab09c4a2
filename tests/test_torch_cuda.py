"""Tests of the port that need a CUDA card: the hand-written kernels against
their plain versions, on the card.  They skip elsewhere.

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.models.common import ParamTree  # noqa: E402
from repro_torch.models.model_zoo import get_model  # noqa: E402

pytestmark = pytest.mark.cuda

# abs tolerance on unit-variance inputs: bf16 rounds probabilities and the
# output (one ulp is 2^-6 at |x| in [2, 4)); f32 differs in sum order only
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}

CASES = [
    # B, H, Hk, Sq, Skv, Dh, causal, window, q_offset, dtype
    (2, 8, 2, 256, 256, 128, True, None, 0, torch.bfloat16),
    (1, 4, 2, 1000, 1000, 128, True, None, 0, torch.bfloat16),       # ragged
    (1, 4, 2, 512, 512, 64, True, 96, 0, torch.bfloat16),            # window
    (1, 4, 2, 64, 1024, 128, True, None, 960, torch.bfloat16),       # q_offset
    (1, 8, 1, 300, 300, 128, True, None, 0, torch.bfloat16),         # MQA
    (2, 4, 4, 200, 130, 32, False, None, 0, torch.bfloat16),         # non-causal
    (2, 4, 2, 100, 100, 16, True, None, 0, torch.bfloat16),
    (2, 4, 2, 333, 333, 128, True, None, 0, torch.float32),
    (1, 4, 2, 256, 256, 64, True, 40, 0, torch.float32),
    (1, 4, 2, 64, 128, 64, False, 16, 100, torch.bfloat16),          # rows that see no key
    (1, 4, 2, 64, 128, 32, False, 16, 100, torch.float32),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(case, seed=0):
    B, H, Hk, Sq, Skv, Dh, *_, dtype = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(s, generator=g, device="cuda").to(dtype)
            for s in ((B, H, Sq, Dh), (B, Hk, Skv, Dh), (B, Hk, Skv, Dh))]


@pytest.mark.parametrize("case", CASES)
def test_flash_fwd_matches_plain_version(card, case):
    *_, causal, window, q_offset, dtype = case
    q, k, v = _inputs(case)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = fa.LAUNCHES
    out = fa.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    assert out.dtype == dtype and out.shape == q.shape and torch.isfinite(out).all()
    ref = attention_ref(q, k, v, **kw)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


def test_model_layout_takes_strided_views(card):
    g = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn(2, 128, 8, 64, generator=g, device="cuda").bfloat16()
    k = torch.randn(2, 128, 2, 64, generator=g, device="cuda").bfloat16()
    v = torch.randn(2, 128, 2, 64, generator=g, device="cuda").bfloat16()
    out = flash_attention(q, k, v)
    assert out.is_contiguous()
    ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[torch.bfloat16]


def test_forward_only_refuses_grad(card):
    q = torch.randn(1, 64, 2, 64, device="cuda", requires_grad=True)
    with pytest.raises(NotImplementedError, match="training slice"):
        flash_attention(q, q.detach()[:, :, :1], q.detach()[:, :, :1])


def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    q = torch.randn(1, 2, 64, 64, device="cuda")
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(q[..., :48].contiguous(), q[..., :48].contiguous(),
                               q[..., :48].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.randn(1, 2, 64, 128, device="cuda")[..., ::2]
        fa.flash_attention_fwd(t, t, t)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_model_on_card_matches_cpu(card, arch):
    """Flash kernel on the card vs the plain path on the CPU, same weights."""
    cpu_zoo = get_model(get_smoke_config(arch))
    gpu_zoo = get_model(dataclasses.replace(get_smoke_config(arch), attn_impl="flash"))
    params = cpu_zoo.init(0, device="cpu")
    gpu_params = ParamTree.from_state_dict({k: v.cuda() for k, v in params.state_dict().items()})
    tokens = torch.randint(0, cpu_zoo.cfg.vocab, (2, 70), generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        want, _ = cpu_zoo.forward(params, {"tokens": tokens})
        got, _ = gpu_zoo.forward(gpu_params, {"tokens": tokens.cuda()})
    assert (got.cpu() - want).abs().max().item() <= 1e-3
