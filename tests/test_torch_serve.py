"""The port's serving path on the CPU: the wave server over prefill_fn /
decode_fn answers every request with JAX's greedy tokens, the slot
scheduler behaves as the reference's, and the entry points refuse to run
without a card unless asked for the CPU."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models.model_zoo import get_model as jax_get_model  # noqa: E402
from repro.serve.serve_step import BatchScheduler as JaxScheduler, Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models.common import ParamTree  # noqa: E402
from repro_torch.models.model_zoo import get_model  # noqa: E402
from repro_torch.serve.serve_step import (  # noqa: E402
    BatchScheduler, Request, make_serve_step, serve_waves,
)

ARCH = "qwen3-8b"


def _setup(attn_impl="flash"):
    jzoo = jax_get_model(jax_smoke(ARCH))
    jp = jax.jit(jzoo.init)(jax.random.PRNGKey(0))
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), dtype="float32", device="cpu")
    zoo = get_model(dataclasses.replace(get_smoke_config(ARCH), attn_impl=attn_impl))
    return jzoo, jp, zoo, ParamTree.from_state_dict(sd)


def _requests(n, prompt_len, max_new, vocab, cls=Request):
    rng = np.random.RandomState(0)
    return [cls(rid=i, prompt=rng.randint(2, vocab, prompt_len), max_new=max_new) for i in range(n)]


def test_wave_server_answers_every_request_with_jax_greedy_tokens():
    jzoo, jp, zoo, params = _setup()
    reqs = _requests(6, prompt_len=12, max_new=5, vocab=zoo.cfg.vocab)
    sched = BatchScheduler(slots=4, eos_id=-1)  # no EOS: every request runs to max_new
    for r in reqs:
        sched.submit(r)
    waves = serve_waves(zoo, make_serve_step(zoo, device="cpu"), params, sched, 16, device="cpu")
    assert [len(w.requests) for w in waves] == [4, 2] and sched.idle
    assert all(r.done and len(r.generated) == 5 for r in reqs)
    for w in waves:
        # prefill (kernel path) and cache fill (plain path): f32, same function
        torch.testing.assert_close(w.prefill_last, w.fill_last, atol=1e-4, rtol=1e-4)
        assert w.decode_steps == 4

    # JAX greedy decode of each prompt on its own: prompt fill, then steps
    fwd, dec = jax.jit(jzoo.forward), jax.jit(jzoo.decode_step)
    for r in reqs:
        toks = jnp.asarray(r.prompt[None], jnp.int32)
        logits, _ = fwd(jp, {"tokens": toks})
        out = [int(jnp.argmax(logits[0, -1]))]
        _, cache = dec(jp, jzoo.init_cache(1, 16), {"tokens": toks})
        for _ in range(4):
            lg, cache = dec(jp, cache, {"tokens": jnp.asarray([[out[-1]]], jnp.int32)})
            out.append(int(jnp.argmax(lg[0, -1])))
        assert r.generated == out, r.rid


def test_wave_server_stops_a_request_at_eos():
    _, _, zoo, params = _setup(attn_impl="ref")
    arts = make_serve_step(zoo, device="cpu")

    def serve(eos_id):
        (req,) = _requests(1, prompt_len=6, max_new=5, vocab=zoo.cfg.vocab)
        sched = BatchScheduler(slots=2, eos_id=eos_id)
        sched.submit(req)
        serve_waves(zoo, arts, params, sched, 12, device="cpu")
        return req

    free = serve(-1).generated
    eos = free[2]
    stopped = serve(eos)
    assert stopped.done and stopped.generated == free[:free.index(eos) + 1]


def test_wave_server_refuses_unequal_prompts_and_short_caches():
    _, _, zoo, params = _setup(attn_impl="ref")
    arts = make_serve_step(zoo, device="cpu")
    sched = BatchScheduler(slots=2)
    sched.submit(Request(0, np.arange(2, 8), 3))
    sched.submit(Request(1, np.arange(2, 9), 3))
    with pytest.raises(ValueError, match="one length"):
        serve_waves(zoo, arts, params, sched, 32, device="cpu")
    sched = BatchScheduler(slots=2)
    sched.submit(Request(0, np.arange(2, 8), 4))
    with pytest.raises(ValueError, match="too short"):
        serve_waves(zoo, arts, params, sched, 8, device="cpu")


def test_scheduler_matches_reference():
    sampled = np.random.RandomState(1).randint(0, 4, (12, 3))
    ours, ref = BatchScheduler(slots=3, eos_id=0), JaxScheduler(slots=3, eos_id=0)
    for a, b in zip(_requests(5, 4, 3, 50), _requests(5, 4, 3, 50, JaxRequest)):
        ours.submit(a)
        ref.submit(b)
    for row in sampled:
        assert [r.rid for r in ours.admit()] == [r.rid for r in ref.admit()]
        ours.step_tokens(row)
        ref.step_tokens(row)
        assert {s: r.rid for s, r in ours.active.items()} == {s: r.rid for s, r in ref.active.items()}
        assert ours.idle == ref.idle


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    zoo = get_model(get_smoke_config(ARCH))
    for call in (lambda: zoo.init(0), lambda: zoo.init_cache(2, 8), lambda: make_serve_step(zoo)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert zoo.init_cache(2, 8, device="cpu")["index"] == 0
