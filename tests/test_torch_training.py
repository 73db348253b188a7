"""The port's training path against the JAX package's, on the reference's
own float weights (``repro.models.transformer.init_params``, converted by
``repro_torch.convert.float_params_from_reference``) and the same batches:
the float parameter tree, ``forward_hidden`` / ``forward_train`` (dense
llama3-8b and MoE dbrx-132b, the aux pair included), one training step's
loss and every gradient leaf against ``jax.value_and_grad``, AdamW and
Adafactor updates leaf by leaf, the schedule and the clipping, chunked
against unchunked cross entropy, ``default_opt_for``, the data pipeline,
checkpoints in both directions, the loss falling, the launcher, and the
backward of the two kernels' ``autograd.Function``s.

The reference's steps are compiled with ``xla_allow_excess_precision`` off,
as in ``test_torch_engine.py``.  The port computes every dot in float32
from the bf16 operands as the reference's CPU path does, but sums in
another order, so values agree to float32 rounding and each bf16
rounding that follows: the tolerances below are relative L2 errors."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import checkpoint as JC  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro.training import train_loop as JTL  # noqa: E402
from repro_torch import convert as CV  # noqa: E402
from repro_torch.configs import registry as PR  # noqa: E402
from repro_torch.data import pipeline as PD  # noqa: E402
from repro_torch.kernels import flash_prefill as FP  # noqa: E402
from repro_torch.kernels import loader  # noqa: E402
from repro_torch.kernels import rmsnorm as RN  # noqa: E402
from repro_torch.launch import train as PLT  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.training import checkpoint as PC  # noqa: E402
from repro_torch.training import optimizer as PO  # noqa: E402
from repro_torch.training import train_loop as PTL  # noqa: E402

STRICT = {"xla_allow_excess_precision": False}
ARCHS = ("llama3-8b@tiny", "dbrx-132b@tiny")
KEY = jax.random.PRNGKey(0)
# a layer's output, the final hidden state and the logits: bf16 roundings
# after float32 sums in another order
HIDDEN_REL_L2 = 1e-2
AUX_REL = 1e-3          # the MoE load-balance and z losses (float32 means)
LOSS_REL = 1e-3
GRAD_REL_L2 = 2e-2      # each gradient leaf (measured: at most 8e-3)
# optimizer updates from identical float32 inputs: each leaf's largest
# difference against its largest magnitude (a subtraction that cancels
# leaves a one-ulp difference of its operands large against the result)
OPT_REL = 1e-6


def _rel_l2(a, b) -> float:
    a = np.asarray(jnp.asarray(a, jnp.float32), np.float64)
    b = b.detach().float().numpy().astype(np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


@pytest.fixture(scope="module")
def models():
    """arch -> (cfg, reference float tree, the port's copy of it)."""
    built = {}

    def get(arch):
        if arch not in built:
            jp = JT.init_params(JR.get(arch), key=KEY)
            built[arch] = (PR.get(arch), jp, CV.float_params_from_reference(jp))
        return built[arch]
    return get


def _batch(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    return ({"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab), "mask": jnp.asarray(mask)},
            {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab),
             "mask": torch.from_numpy(mask)})


def _paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in flat]


@pytest.mark.parametrize("arch", ARCHS + ("qwen2-1.5b@tiny",))
def test_float_tree_matches_reference(arch, models):
    """The port's own float tree has the reference's keys, nesting, shapes
    and dtypes (embedding included, lm_head a separate bf16 linear even for
    qwen2-1.5b's tied config, norms float32, the router bf16); the
    converted tree carries every reference leaf byte for byte."""
    cfg, jp, conv = models(arch) if arch in ARCHS else (
        PR.get(arch), JT.init_params(JR.get(arch), key=KEY), None)
    own = PT.init_params(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    ref = _paths(jp)
    mine = list(zip(PO.leaves(own), PO.leaves(conv if conv is not None
                                             else CV.float_params_from_reference(jp))))
    assert len(ref) == len(mine)
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    for (path, a), (o, c) in zip(ref, mine):
        assert tuple(o.shape) == a.shape and o.dtype == dtypes[a.dtype.name], path
        assert CV.to_numpy(c).tobytes() == a.tobytes(), path
    assert set(own) == {"embedding", "stacks", "final_norm", "lm_head"}
    assert own["embedding"].shape == (cfg.padded_vocab_size, cfg.d_model)
    assert own["lm_head"]["w"].dtype == torch.bfloat16
    assert set(PT.init_params(cfg, torch.Generator().manual_seed(0), torch.device("cpu"),
                              quantized=True)) == {"stacks", "final_norm", "lm_head"}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, models):
    """``forward_hidden`` (every layer's output, the normed hidden state
    and the MoE aux pair) and ``forward_train``'s logits."""
    cfg, jp, pp = models(arch)
    jb, pb = _batch(cfg)
    jcfg = JR.get(arch)
    fwd = jax.jit(lambda p, b: JT.forward_train(p, jcfg, b)).lower(jp, jb).compile(STRICT)
    hid = jax.jit(lambda p, b: JT.forward_hidden(p, jcfg, b)).lower(jp, jb).compile(STRICT)
    jlogits, jaux = fwd(jp, jb)
    jh, jaux2 = hid(jp, jb)
    with torch.no_grad():
        ph, paux = PT.forward_hidden(pp, cfg, pb)
        plogits, paux2 = PT.forward_train(pp, cfg, pb)
    assert plogits.dtype == torch.float32 and plogits.shape == jlogits.shape
    assert _rel_l2(jh, ph) < HIDDEN_REL_L2
    assert _rel_l2(jlogits, plogits) < HIDDEN_REL_L2
    for ja, pa in ((jaux, paux2), (jaux2, paux)):
        np.testing.assert_allclose(np.asarray(ja), pa.numpy(), rtol=AUX_REL, atol=1e-6)
    if cfg.num_experts:
        assert float(paux[0]) > 0.99 and float(paux[1]) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_loss_and_grads_match_reference(arch, models):
    """One step's loss (``LOSS_REL``) and every gradient leaf
    (``GRAD_REL_L2``) against ``jax.value_and_grad`` of the reference's
    ``loss_fn`` under remat; the port's remat (``torch.utils.checkpoint``
    per layer) changes no bit; the optimizer step moves every leaf."""
    cfg, jp, pp = models(arch)
    jb, pb = _batch(cfg)
    jcfg = JR.get(arch)
    ctx = JT.StepCtx(jcfg, remat=True)
    vg = jax.jit(jax.value_and_grad(lambda p: JTL.loss_fn(p, jcfg, jb, ctx), has_aux=True))
    (jtotal, jm), jg = vg.lower(jp).compile(STRICT)(jp)
    (ptotal, pm), pg = PTL.value_and_grad(pp, cfg, pb, PT.StepCtx(cfg, remat=True))
    for k in ("loss", "moe_lb", "moe_z"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=LOSS_REL, atol=1e-6)
    np.testing.assert_allclose(float(ptotal), float(jtotal), rtol=LOSS_REL)
    for (path, a), b, leaf in zip(_paths(jg), PO.leaves(pg), PO.leaves(pp)):
        assert b.dtype == leaf.dtype and _rel_l2(a, b) < GRAD_REL_L2, path
    (ntotal, _), ng = PTL.value_and_grad(pp, cfg, pb, PT.StepCtx(cfg, remat=False))
    assert float(ntotal) == float(ptotal)
    assert all(torch.equal(a, b) for a, b in zip(PO.leaves(ng), PO.leaves(pg)))
    opt = PTL.default_opt_for(cfg)
    step = PTL.make_train_step(cfg, opt)
    new, state, m = step(pp, PO.init_state(opt, pp), pb)
    assert int(state["step"]) == 1 and np.isfinite(float(m["grad_norm"]))
    assert all(not torch.equal(a, b) for a, b in zip(PO.leaves(new), PO.leaves(pp)))


def _f32(tree):
    return jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), tree)


@pytest.fixture(scope="module")
def f32_grads(models):
    """float32 copies of llama3-8b@tiny's reference parameters and of the
    reference's gradients of one step on them."""
    cfg, jp, _pp = models("llama3-8b@tiny")
    jb, _pb = _batch(cfg)
    jcfg = JR.get("llama3-8b@tiny")
    _, jg = jax.jit(jax.value_and_grad(
        lambda p: JTL.loss_fn(p, jcfg, jb, JT.StepCtx(jcfg)), has_aux=True))(jp)
    return _f32(jp), _f32(jg)


@pytest.mark.parametrize("kind", ("adamw", "adafactor"))
def test_optimizer_updates_match_reference(kind, f32_grads):
    """Two updates from identical float32 parameters and gradients (the
    reference's own gradients of one step): every new parameter and state
    leaf within ``OPT_REL`` of its largest magnitude, and the global norm."""
    params, grads = f32_grads
    opt = JO.OptConfig(kind=kind, lr=1e-2, warmup_steps=1, decay_steps=10)
    update = jax.jit(lambda p, g, st: JO.update(opt, p, g, st))
    pparams = CV.float_params_from_reference(params)
    pgrads = CV.float_params_from_reference(grads)
    jstate, pstate = JO.init_state(opt, params), PO.init_state(opt, pparams)
    for _ in range(2):
        params, jstate, jn = update(params, grads, jstate)
        pparams, pstate, pn = PO.update(opt, pparams, pgrads, pstate)
        np.testing.assert_allclose(float(pn), float(jn), rtol=OPT_REL)
        for (path, a), b in zip(_paths({"p": params, "s": jstate}),
                                PO.leaves({"p": pparams, "s": pstate})):
            scale = float(np.abs(a).max()) if a.size else 0.0
            np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=OPT_REL * scale,
                                       err_msg=path)


def test_lr_schedule_and_clipping_match_reference():
    opt = JO.OptConfig(lr=1.0, warmup_steps=10, decay_steps=100)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(float(PO.lr_schedule(opt, s)),
                                   float(JO.lr_schedule(opt, jnp.asarray(s))), rtol=OPT_REL)
    assert float(PO.lr_schedule(opt, 0)) == 0.0 and float(PO.lr_schedule(opt, 100)) < 0.2
    rng = np.random.default_rng(1)
    tree = {"a": rng.normal(size=(4, 8)).astype(np.float32),
            "b": (rng.normal(size=(16,)).astype(np.float32) * 3,)}
    ptree = {"a": torch.from_numpy(tree["a"]), "b": (torch.from_numpy(tree["b"][0]),)}
    for max_norm in (0.5, 100.0):
        jc, jn = JO.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), max_norm)
        scale, pn = PO.clip_scale(ptree, max_norm)
        np.testing.assert_allclose(float(pn), float(jn), rtol=OPT_REL)
        for a, b in zip(jax.tree.leaves(jc), [g.float() * scale for g in PO.leaves(ptree)]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=OPT_REL)


def test_chunked_cross_entropy_matches_unchunked(models):
    """Chunked (4-token chunks under checkpoint) against unchunked, with and
    without a mask: the loss and its gradients; the reference's value."""
    cfg, jp, pp = models("llama3-8b@tiny")
    jh = jax.random.normal(jax.random.PRNGKey(1), (2, 16, cfg.d_model), jnp.bfloat16)
    labels = jax.random.randint(KEY, (2, 16), 0, cfg.vocab_size)
    mask = (labels % 3 != 0).astype(jnp.float32)
    jcfg = JR.get("llama3-8b@tiny")
    for m in (None, mask):
        ref = JTL.chunked_cross_entropy(jh, jp["lm_head"], labels, m, jcfg, chunk=4)
        pm = None if m is None else torch.tensor(np.asarray(m))
        outs = []
        for chunk in (4, 16):
            h = CV.to_tensor(jh).requires_grad_(True)
            w = pp["lm_head"]["w"].clone().requires_grad_(True)
            loss = PTL.chunked_cross_entropy(h, {"w": w}, torch.tensor(np.asarray(labels)),
                                             pm, cfg, chunk=chunk)
            loss.backward()
            outs.append((loss.detach(), h.grad, w.grad))
        np.testing.assert_allclose(float(outs[0][0]), float(outs[1][0]), rtol=1e-5)
        np.testing.assert_allclose(float(outs[0][0]), float(ref), rtol=LOSS_REL)
        for a, b in zip(outs[0][1:], outs[1][1:]):      # bf16 grads, summed per chunk
            assert _rel_l2(a.float().numpy(), b) < HIDDEN_REL_L2


def test_default_opt_for_every_config():
    for arch in JR.ARCHS:
        for variant in ("", "@reduced", "@tiny"):
            assert (PTL.default_opt_for(PR.get(arch + variant)).kind
                    == JTL.default_opt_for(JR.get(arch + variant)).kind), arch + variant
            assert (PR.get(arch + variant).param_count()
                    == JR.get(arch + variant).param_count()), arch + variant
    assert PTL.default_opt_for(PR.get("qwen2-1.5b")).kind == "adamw"
    assert PTL.default_opt_for(PR.get("qwen1.5-110b")).kind == "adafactor"


@pytest.mark.parametrize("seed", (0, 1))
def test_pipeline_batches_bit_equal(seed):
    cfg = dict(batch_size=4, seq_len=96, vocab_size=512, seed=seed)
    ref = JD.Pipeline(JD.DataConfig(**cfg)).batches(12)
    for a, b in zip(ref, PD.Pipeline(PD.DataConfig(**cfg)).batches(12)):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("kind", ("adamw", "adafactor"))
def test_checkpoint_round_trip(kind, models, tmp_path):
    """The port's checkpoint restores bit for bit, under the reference's
    file names, and each package restores the other's."""
    cfg, jp, pp = models("llama3-8b@tiny")
    opt = PO.OptConfig(kind=kind)
    state = PO.init_state(opt, pp)
    state["step"] += 3
    out = PC.save(str(tmp_path / "port"), 7, pp, state)
    assert out.endswith("step_00000007")
    assert sorted(p.name for p in (tmp_path / "port" / "step_00000007").iterdir()) == [
        "arrays.npz", "manifest.json"]
    like = {"params": pp, "opt_state": PO.init_state(opt, pp)}
    bundle, step = PC.restore(str(tmp_path / "port"), like)
    assert step == 7 == PC.latest_step(str(tmp_path / "port"))
    for a, b in zip(PO.leaves(bundle), PO.leaves({"params": pp, "opt_state": state})):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jstate = JO.init_state(JO.OptConfig(kind=kind), jp)
    jbundle, _ = JC.restore(str(tmp_path / "port"), {"params": jp, "opt_state": jstate})
    for a, b in zip(jax.tree.leaves(jbundle), PO.leaves({"params": pp, "opt_state": state})):
        assert CV.to_numpy(b).tobytes() == np.asarray(a).tobytes()
    JC.save(str(tmp_path / "ref"), 5, jp, jstate)
    bundle, step = PC.restore(str(tmp_path / "ref"), like)
    assert step == 5
    for a, b in zip(jax.tree.leaves({"params": jp, "opt_state": jstate}), PO.leaves(bundle)):
        assert CV.to_numpy(b).tobytes() == np.asarray(a).tobytes()


def test_loss_decreases_dense():
    """The reference's ``test_loss_decreases_dense`` on the port:
    llama3-8b@reduced, 60 AdamW steps of 8 x 64 tokens."""
    cfg = PR.get("llama3-8b@reduced")
    params = PT.init_params(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    opt = PO.OptConfig(lr=2e-3, warmup_steps=5, decay_steps=60)
    state = PO.init_state(opt, params)
    step = PTL.make_train_step(cfg, opt, remat=False)
    data = PD.Pipeline(PD.DataConfig(batch_size=8, seq_len=64, vocab_size=cfg.vocab_size))
    losses = []
    for batch in data.batches(60):
        params, state, m = step(params, state,
                                {k: torch.from_numpy(v) for k, v in batch.items()})
        losses.append(float(m["loss"]))
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    assert last < first - 0.2, (first, last)
    assert np.isfinite(losses).all()


def test_launch_train_on_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch qwen2-7b@tiny --device cpu
    --steps 3``, with a checkpoint directory; run again, it restores step 3."""
    ck = str(tmp_path / "ck")
    out = PLT.main(["--arch", "qwen2-7b@tiny", "--device", "cpu", "--steps", "3",
                    "--ckpt-dir", ck])
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert PC.latest_step(ck) == 3
    again = PLT.main(["--arch", "qwen2-7b@tiny", "--device", "cpu", "--steps", "3",
                      "--ckpt-dir", ck])
    assert again["losses"] == []
    text = capsys.readouterr().out
    assert "[train] restored step 3" in text and "[train] done: loss" in text


def test_function_backward_is_plain_autograd_on_cpu():
    """Each kernel's ``autograd.Function`` on the CPU (its forward is the
    wrapper, which takes the plain version there): the output and every
    input gradient equal autograd of the plain version, with all inputs
    requiring grad and with some."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 5, 64), generator=g).to(torch.bfloat16)
    w = 1 + 0.1 * torch.randn((64,), generator=g)
    q, k, v = (torch.randn(shape, generator=g).to(torch.bfloat16)
               for shape in ((2, 24, 4, 64), (2, 24, 2, 64), (2, 24, 2, 64)))
    cases = [(RN.RMSNormFunction.apply, lambda a, b: RN.rmsnorm_plain(a, b, 1e-5),
              (x, w), (1e-5,)),
             (FP.FlashPrefillFunction.apply,
              lambda a, b, c: FP.flash_prefill_attention_plain(a, b, c, causal=True),
              (q, k, v), (True, 0))]
    for fn, plain, inputs, extra in cases:
        for needs in ([True] * len(inputs), [False] + [True] * (len(inputs) - 1)):
            a = [t.clone().requires_grad_(n) for t, n in zip(inputs, needs)]
            b = [t.clone().requires_grad_(n) for t, n in zip(inputs, needs)]
            ya, yb = fn(*a, *extra), plain(*b)
            assert torch.equal(ya, yb)
            grad = torch.randn(ya.shape, generator=g).to(ya.dtype)
            ya.backward(grad)
            yb.backward(grad)
            for ta, tb, n in zip(a, b, needs):
                assert (ta.grad is None) == (not n)
                if n:
                    assert torch.equal(ta.grad, tb.grad)


def test_refuse_grad_guard():
    """The guard every wrapper runs before a launch: inputs that require
    grad under grad mode raise; under ``no_grad`` or without them it
    passes."""
    t = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="autograd Function"):
        loader.refuse_grad("rmsnorm", torch.ones(3), t)
    loader.refuse_grad("rmsnorm", torch.ones(3))
    with torch.no_grad():
        loader.refuse_grad("rmsnorm", t)


def test_launch_train_refuses_silent_cpu_fallback(monkeypatch):
    """Without a card the launcher's default device raises before building
    anything; ``--device cpu`` is the explicit way to the plain path."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PLT.main(["--arch", "qwen2-7b@tiny", "--steps", "1"])
