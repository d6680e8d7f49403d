"""The port's continuous-batching engine (``repro_torch.serving.engine``)
and serving entry point (``repro_torch.launch.serve``) at the reduced
smollm-360m config, on the CPU; at the end, the engine at reduced
mamba2-370m and hymba-1.5b against the JAX engine, and the slot-reuse
repair (an admitted slot's SSM state starts from zero).

The first seven tests are those of ``tests/test_engine.py``, run against
the port. The reference tests then drive the JAX package's engine on the
same parameters and prompts: greedy tokens must be equal, except after a
step where the reference's two largest logits lie within ``NEAR_TIE``
(f32 logits of the two packages differ by up to ~3e-6, so such a step
could pick either token); the test names any such step.
"""
import torch_threads  # noqa: F401  (one torch thread a test worker)
import types

import numpy as np
import pytest
import torch
from test_torch_model import reference_shim

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import serve as tserve
from repro_torch.models import api
from repro_torch.serving.engine import ContinuousBatchingEngine
from repro_torch.serving.router import Completion, RosellaRouter

NEAR_TIE = 1e-4


def _cfg():
    return tconfigs.reduced(tconfigs.get_config("smollm-360m"))


def _params(cfg, seed=0):
    return api.init_params(cfg, seed, "cpu")


def _sequential_generate(cfg, params, prompt, n_new, max_len=64):
    cache = api.init_cache(cfg, 1, max_len, "cpu")
    tok = None
    out = []
    for t in range(len(prompt) + n_new - 1):
        cur = torch.tensor([[prompt[t]]]) if t < len(prompt) else tok
        logits, cache = api.decode_fn(cfg, params, {"tokens": cur, "pos": t}, cache)
        tok = torch.argmax(logits[:, -1:], -1)
        if t >= len(prompt) - 1:
            out.append(int(tok[0, 0]))
    return out


# ---------------------------------------------------------------------------
# tests/test_engine.py, against the port
# ---------------------------------------------------------------------------


def test_engine_matches_sequential_decode():
    cfg = _cfg()
    params = _params(cfg)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab, size=3) for _ in range(3)]
    n_new = 5

    eng = ContinuousBatchingEngine(cfg, params, n_slots=4, max_len=64)
    for rid, p in enumerate(prompts):
        assert eng.try_admit(rid, p, n_new)
    results = {}
    for _ in range(n_new + 2):
        for rid, toks in eng.step():
            results[rid] = toks
        if len(results) == len(prompts):
            break
    assert set(results) == {0, 1, 2}
    for rid, p in enumerate(prompts):
        assert results[rid] == _sequential_generate(cfg, params, list(p), n_new)


def test_engine_continuous_admission():
    """A new request admitted mid-flight must not disturb running slots."""
    cfg = _cfg()
    params = _params(cfg)
    rng = np.random.RandomState(1)
    p0 = rng.randint(1, cfg.vocab, size=3)
    p1 = rng.randint(1, cfg.vocab, size=3)

    eng = ContinuousBatchingEngine(cfg, params, n_slots=2, max_len=64)
    assert eng.try_admit(0, p0, 6)
    assert not eng.step()  # advance slot 0 once
    assert eng.try_admit(1, p1, 2)  # admit mid-flight
    results = {}
    for _ in range(8):
        for rid, toks in eng.step():
            results[rid] = toks
    assert results[0] == _sequential_generate(cfg, params, list(p0), 6)
    assert results[1] == _sequential_generate(cfg, params, list(p1), 2)


def test_engine_batch_admission_matches_sequential():
    """``try_admit_batch`` replays all admitted prompts together; outputs
    equal the per-request sequential decode, and overflow requests are
    rejected without disturbing admitted ones."""
    cfg = _cfg()
    params = _params(cfg)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, cfg.vocab, size=ln) for ln in (3, 5, 2, 4)]
    n_new = 4

    eng = ContinuousBatchingEngine(cfg, params, n_slots=3, max_len=64)
    accept = eng.try_admit_batch([(rid, p, n_new) for rid, p in enumerate(prompts)])
    assert accept == [True, True, True, False]  # 3 slots, 4 requests

    results = {}
    for _ in range(n_new + 2):
        for rid, toks in eng.step():
            results[rid] = toks
    assert set(results) == {0, 1, 2}
    for rid in range(3):
        assert results[rid] == _sequential_generate(cfg, params, list(prompts[rid]), n_new)

    # freed slots admit the straggler; its decode is undisturbed
    assert eng.try_admit_batch([(3, prompts[3], n_new)]) == [True]
    for _ in range(n_new + 2):
        for rid, toks in eng.step():
            results[rid] = toks
    assert results[3] == _sequential_generate(cfg, params, list(prompts[3]), n_new)


def _traced_engine(cfg, params, shapes, **kw):
    """Engine whose admission-replay shapes are recorded."""
    eng = ContinuousBatchingEngine(cfg, params, **kw)
    orig = eng._admit_replay_multi
    eng._admit_replay_multi = (
        lambda *a: (shapes.append(int(a[1].shape[0])) or True) and orig(*a)
    )
    return eng


def test_engine_chunked_prefill_matches_whole_prompt():
    """prefill_chunk=C replays admission in [C, n_slots] pieces; the decoded
    outputs equal whole-prompt replay."""
    cfg = _cfg()
    params = _params(cfg)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, cfg.vocab, size=ln) for ln in (9, 17, 4)]
    n_new = 4

    outs, shapes = {}, {}
    for C in (None, 8):
        seen: list = []
        eng = _traced_engine(cfg, params, seen, n_slots=3, max_len=64, prefill_chunk=C)
        assert eng.try_admit_batch(
            [(rid, p, n_new) for rid, p in enumerate(prompts)]) == [True] * 3
        results = {}
        for _ in range(n_new + 2):
            for rid, toks in eng.step():
                results[rid] = toks
        outs[C], shapes[C] = results, seen
    # P = 16 token steps: one 16-step bucket vs two 8-step chunks
    assert shapes[None] == [16]
    assert shapes[8] == [8, 8]
    assert outs[None] == outs[8]
    for rid, p in enumerate(prompts):
        assert outs[8][rid] == _sequential_generate(cfg, params, list(p), n_new)


def test_engine_chunked_prefill_cost_scales_with_chunk():
    """Under prefill_chunk every replay piece is C long, whatever the
    prompt; without it each prompt length takes its power-of-two bucket."""
    cfg = _cfg()
    params = _params(cfg, 4)
    rng = np.random.RandomState(4)
    prompts = {rid: rng.randint(1, cfg.vocab, size=ln) for rid, ln in enumerate((21, 71))}

    shapes = {}
    for C in (None, 16):
        seen: list = []
        eng = _traced_engine(cfg, params, seen, n_slots=2, max_len=128, prefill_chunk=C)
        for rid, p in prompts.items():
            assert eng.try_admit(rid, p, 1)
            eng.step()
        shapes[C] = seen
    assert set(shapes[16]) == {16}
    assert len(shapes[16]) == 2 + 5  # ceil(20/16) + ceil(70/16) pieces
    assert shapes[None] == [32, 128]


def test_engine_prefill_chunk_validates():
    cfg = _cfg()
    with pytest.raises(ValueError, match="prefill_chunk"):
        ContinuousBatchingEngine(cfg, _params(cfg), prefill_chunk=0)


def test_engine_slot_reuse_and_capacity():
    cfg = _cfg()
    eng = ContinuousBatchingEngine(cfg, _params(cfg), n_slots=1, max_len=32)
    assert eng.try_admit(0, np.array([1, 2]), 2)
    assert not eng.try_admit(1, np.array([3]), 2)  # full
    for _ in range(3):
        eng.step()
    assert eng.utilization == 0.0
    assert eng.try_admit(1, np.array([3]), 2)  # slot freed and reusable


def test_engine_rows_at_the_end_of_the_cache():
    """A slot finishes at max_len - 1; its idle row keeps being computed
    at that (clamped) index without disturbing the live one."""
    cfg = _cfg()
    params = _params(cfg)
    eng = ContinuousBatchingEngine(cfg, params, n_slots=2, max_len=8)
    assert eng.try_admit_batch([(0, np.array([5, 6, 7]), 20), (1, np.array([9]), 3)])
    results = {}
    for _ in range(12):
        for rid, toks in eng.step():
            results[rid] = toks
    assert len(results[0]) == 5  # positions 2..6: stops at max_len - 1
    assert results[0] == _sequential_generate(cfg, params, [5, 6, 7], 5, max_len=8)
    assert results[1] == _sequential_generate(cfg, params, [9], 3, max_len=8)


# ---------------------------------------------------------------------------
# against the JAX package's engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref():
    """The JAX package's engine and model API, imported under the jax-0.9
    shim (see tests/test_torch_model.py), with params carried across."""
    with reference_shim():
        import jax
        import jax.numpy as jnp

        from repro import configs
        from repro.models import api as japi
        from repro.serving import engine as jengine

        cfg = configs.reduced(configs.get_config("smollm-360m"))
        params = japi.init_params(cfg, jax.random.PRNGKey(0))
        tree = {".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
                np.asarray(leaf)
                for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
        decode = jax.jit(lambda params, tokens, pos, cache: japi.decode_fn(
            cfg, params, {"tokens": tokens, "pos": pos}, cache))
        yield types.SimpleNamespace(
            jax=jax, jnp=jnp, api=japi, decode=decode, engine=jengine, cfg=cfg, configs=configs,
            params=params,
            tcfg=_cfg(), model=convert.lm_params_from_numpy(_cfg(), tree, "cpu"))


def _reference_logits(ref, prompt, n_new):
    """The reference's logits at each generated step (sequential decode)."""
    cache = ref.api.init_cache(ref.cfg, 1, 64)
    out, tok = [], None
    for t in range(len(prompt) + n_new - 1):
        cur = ref.jnp.asarray([[prompt[t]]], ref.jnp.int32) if t < len(prompt) else tok
        logits, cache = ref.decode(ref.params, cur, ref.jnp.int32(t), cache)
        tok = ref.jnp.argmax(logits[:, -1:], -1).astype(ref.jnp.int32)
        if t >= len(prompt) - 1:
            out.append(np.asarray(logits[0, -1]))
    return out


def _schedule(eng, prompts, n_new):
    """Batch admission of the first three, one tick, then the fourth
    mid-flight; run until all finish."""
    eng.try_admit_batch([(rid, p, n_new) for rid, p in enumerate(prompts[:3])])
    results = {rid: toks for rid, toks in eng.step()}
    assert eng.try_admit_batch([(3, prompts[3], n_new)]) == [True]
    for _ in range(3 * n_new):
        for rid, toks in eng.step():
            results[rid] = toks
    return results


@pytest.mark.parametrize("chunk", [None, 4])
def test_engine_tokens_match_reference_engine(ref, chunk):
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, ref.cfg.vocab, size=ln) for ln in (6, 3, 9, 5)]
    n_new = 6
    want = _schedule(ref.engine.ContinuousBatchingEngine(
        ref.cfg, ref.params, n_slots=4, max_len=64, prefill_chunk=chunk), prompts, n_new)
    got = _schedule(ContinuousBatchingEngine(
        ref.tcfg, ref.model, n_slots=4, max_len=64, prefill_chunk=chunk), prompts, n_new)
    assert set(got) == set(want) == {0, 1, 2, 3}
    near_ties = []
    for rid, p in enumerate(prompts):
        logits = _reference_logits(ref, list(p), n_new)
        assert [int(np.argmax(lg)) for lg in logits] == want[rid]
        for i, (g, w) in enumerate(zip(got[rid], want[rid])):
            top2 = np.sort(logits[i])[-2:]
            if top2[1] - top2[0] < NEAR_TIE:
                near_ties.append((rid, i, float(top2[1] - top2[0])))
                break  # past a near-tie the two sequences may part
            assert g == w, (rid, i, got[rid], want[rid])
    print(f"near-ties (rid, step, top-2 gap): {near_ties}")


def test_sequential_decode_matches_reference(ref):
    rng = np.random.RandomState(8)
    for ln in (1, 4, 7):
        p = list(rng.randint(1, ref.cfg.vocab, size=ln))
        want = [int(np.argmax(lg)) for lg in _reference_logits(ref, p, 5)]
        assert _sequential_generate(ref.tcfg, ref.model, p, 5) == want


# ---------------------------------------------------------------------------
# the router's completions and the serving entry point
# ---------------------------------------------------------------------------


def test_router_complete_folds_like_complete_arrays():
    comps = [Completion(0, 2, 0.5, 1.25), Completion(1, 0, 0.75, 2.0),
             Completion(2, 2, 1.0, 1.5, fake=True)]
    assert comps[0].service_time == 0.75
    a = RosellaRouter(4, 2.0, seed=1, device="cpu", async_mu=False)
    b = RosellaRouter(4, 2.0, seed=1, device="cpu", async_mu=False)
    a.route(0.1, 3)
    b.route(0.1, 3)
    a.complete(comps)
    b.complete_arrays(np.array([2, 0, 2], np.int32),
                      np.array([0.75, 1.25, 0.5], np.float32), 2.0)
    assert torch.equal(a.q_view, b.q_view)
    np.testing.assert_array_equal(a.mu_hat, b.mu_hat)
    a.complete([])  # an empty batch is a no-op
    assert torch.equal(a.q_view, b.q_view)


@pytest.mark.parametrize("executor", ["engine", "replica"])
def test_serve_main_on_cpu(executor, capsys):
    out = tserve.main(["--device", "cpu", "--executor", executor, "--requests", "6",
                       "--arrival-batch", "3", "--n-new", "3", "--replicas", "3"])
    assert set(out) == {"policy", "executor", "arrival_batch", "mean_ms", "p95_ms",
                        "mu_hat", "true_speeds"}
    assert out["executor"] == executor and out["policy"] == "ppot_sq2"
    assert len(out["mu_hat"]) == 3 and out["true_speeds"] == [1.0, 0.333, 0.2]
    assert out["mean_ms"] > 0 and out["p95_ms"] >= 0
    assert '"executor"' in capsys.readouterr().out


def test_engine_executor_completes_every_request():
    cfg = _cfg()
    params = _params(cfg)
    slowdowns = [1, 3, 5, 1]
    engines = [ContinuousBatchingEngine(cfg, params, n_slots=2, max_len=32)
               for _ in slowdowns]
    router = RosellaRouter(4, 4.0, seed=0, device="cpu")
    args = types.SimpleNamespace(requests=10, arrival_batch=4, n_new=3)
    lat = tserve._run_engine_executor(args, cfg, engines, slowdowns, router,
                                      np.random.RandomState(0))
    assert len(lat) == 10 and (lat >= 0).all()
    assert not any(e.active.any() for e in engines)


def test_serve_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--requests", "1"])


# ---------------------------------------------------------------------------
# the SSM and hybrid families (reduced mamba2-370m, hymba-1.5b)
# ---------------------------------------------------------------------------

SSM_ARCHS = ["mamba2-370m", "hymba-1.5b"]


@pytest.fixture(scope="module")
def ssm_ref(ref):
    """Per arch: the reference's reduced config, parameters and jitted
    decode, and the port's config and model on the same parameters (the
    shim of the ``ref`` fixture is active while it lives)."""
    out = {}
    for arch in SSM_ARCHS:
        cfg = ref.configs.reduced(ref.configs.get_config(arch))
        params = ref.api.init_params(cfg, ref.jax.random.PRNGKey(0))
        tree = {".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
                np.asarray(leaf)
                for path, leaf in ref.jax.tree_util.tree_flatten_with_path(params)[0]}
        tcfg = tconfigs.reduced(tconfigs.get_config(arch))
        decode = ref.jax.jit(lambda params, tokens, pos, cache, cfg=cfg: ref.api.decode_fn(
            cfg, params, {"tokens": tokens, "pos": pos}, cache))
        out[arch] = types.SimpleNamespace(
            jax=ref.jax, jnp=ref.jnp, api=ref.api, engine=ref.engine, cfg=cfg, params=params,
            decode=decode, tcfg=tcfg, model=convert.lm_params_from_numpy(tcfg, tree, "cpu"))
    return out


def _check_tokens(r, prompts, got, want, n_new):
    """got == want, up to the first step whose reference top-2 logits lie
    within NEAR_TIE (sequential reference decode)."""
    assert set(got) == set(want) == set(range(len(prompts)))
    near_ties = []
    for rid, p in enumerate(prompts):
        logits = _reference_logits(r, list(p), n_new)
        assert [int(np.argmax(lg)) for lg in logits] == want[rid]
        for i, (g, w) in enumerate(zip(got[rid], want[rid])):
            top2 = np.sort(logits[i])[-2:]
            if top2[1] - top2[0] < NEAR_TIE:
                near_ties.append((rid, i, float(top2[1] - top2[0])))
                break  # past a near-tie the two sequences may part
            assert g == w, (rid, i, got[rid], want[rid])
    print(f"near-ties (rid, step, top-2 gap): {near_ties}")


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("chunk", [None, 4])
def test_ssm_engine_tokens_match_reference_engine(ssm_ref, arch, chunk):
    """Batch admission of three, one tick, a fourth admitted mid-flight,
    whole and chunked replay; four slots, so no slot is reused."""
    r = ssm_ref[arch]
    rng = np.random.RandomState(9)
    prompts = [rng.randint(1, r.cfg.vocab, size=ln) for ln in (6, 3, 9, 5)]
    n_new = 6
    want = _schedule(r.engine.ContinuousBatchingEngine(
        r.cfg, r.params, n_slots=4, max_len=64, prefill_chunk=chunk), prompts, n_new)
    got = _schedule(ContinuousBatchingEngine(
        r.tcfg, r.model, n_slots=4, max_len=64, prefill_chunk=chunk), prompts, n_new)
    _check_tokens(r, prompts, got, want, n_new)


def _serve_in_one_slot(engine_cls, cfg, params, prompts, n_new):
    """Serve ``prompts`` one after another through a one-slot engine."""
    eng = engine_cls(cfg, params, n_slots=1, max_len=64)
    outs = []
    for rid, p in enumerate(prompts):
        assert eng.try_admit(rid, np.asarray(p), n_new)
        done = []
        while not done:
            done = eng.step()
        outs.append(done[0][1])
    return outs


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_slot_reuse_starts_from_a_fresh_state(ssm_ref, arch):
    """Request B served in the slot that request A just freed gives the
    tokens of B served fresh, in the port; the reference's B after A
    differs from its fresh B, because its admission resets only the slot's
    position and B starts from A's final SSM state
    (``src/repro/serving/engine.py:141-151``)."""
    r = ssm_ref[arch]
    A, B, n_new = [5, 9, 11, 3], [7, 2, 8, 4], 6
    port_after = _serve_in_one_slot(ContinuousBatchingEngine, r.tcfg, r.model, [A, B], n_new)[1]
    port_fresh = _serve_in_one_slot(ContinuousBatchingEngine, r.tcfg, r.model, [B], n_new)[0]
    ref_after = _serve_in_one_slot(r.engine.ContinuousBatchingEngine, r.cfg, r.params, [A, B],
                                   n_new)[1]
    ref_fresh = _serve_in_one_slot(r.engine.ContinuousBatchingEngine, r.cfg, r.params, [B],
                                   n_new)[0]
    assert port_after == port_fresh
    _check_tokens(r, [B], {0: port_fresh}, {0: ref_fresh}, n_new)
    assert ref_after != ref_fresh  # the reference's leak, pinned


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("executor", ["engine", "replica"])
def test_serve_main_serves_the_ssm_families_on_cpu(arch, executor):
    """``--arch mamba2-370m`` / ``hymba-1.5b`` through both executors; the
    replica executor replays each decode ``slowdown`` times on one input
    cache, which a decode leaves unchanged."""
    out = tserve.main(["--device", "cpu", "--arch", arch, "--executor", executor,
                       "--requests", "4", "--arrival-batch", "2", "--n-new", "2",
                       "--replicas", "2"])
    assert out["executor"] == executor and len(out["mu_hat"]) == 2
    assert out["mean_ms"] > 0


def test_replica_slowdown_gives_the_tokens_of_one_decode():
    """A slowdown-3 replica emits the tokens of a slowdown-1 one at reduced
    mamba2: the SSM state advances once per token, not once per replay."""
    cfg = tconfigs.reduced(tconfigs.get_config("mamba2-370m"))
    model = _params(cfg)
    prompt = np.array([5, 9, 11, 3])
    one = tserve.LocalReplica(cfg, model, 1).serve(prompt, 5)
    three = tserve.LocalReplica(cfg, model, 3).serve(prompt, 5)
    assert one.tolist() == three.tolist() == _sequential_generate(cfg, model, list(prompt), 5)
