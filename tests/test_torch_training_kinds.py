"""Training of every other layer kind, the port against the JAX package on
the reference's own float weights (converted by
``repro_torch.convert.float_params_from_reference``) and the same batches:

- gemma3-27b@reduced: a window-16 layer and a global one, T = 40, so the
  window's mask acts;
- rwkv6-7b@tiny: seven rwkv6 layers, each from a zero state;
- jamba-1.5-large-398b@reduced: an attention layer and a mamba layer with
  an MoE FFN, also at T = 28, which the mamba scan pads to its 8-token
  blocks;
- seamless-m4t-large-v2@reduced: a random source of T / 4 frames through
  the encoder, then the decoder's cross attention over quantized caches;
- qwen2-vl-2b@reduced: ``embeds`` batches (the vision frontend's), M-RoPE
  on text positions.

For each: the float tree; every layer's output and its backward on the
reference's own input to that layer (``jax.vjp`` of the reference's
train-mode layer against autograd of the port's, one cotangent for both:
every parameter and input gradient); the hidden state, the logits and the
MoE aux; one step's loss and every gradient leaf against
``jax.value_and_grad`` of the reference's ``loss_fn`` under remat (a leaf
zero on one side is zero on the other); remat equal bit for bit to no
remat; one optimizer step.  Then seamless's cross ``wk`` and ``wv``
gradients, which reach the keys only through their scale and zero and the
values through the fp8 cast, the frontend batches of the launcher, and
kernel 6's ``autograd.Function`` on the CPU.

The reference is compiled with ``xla_allow_excess_precision`` off, as in
``test_torch_training.py``, whose tolerances these are.  Through a whole
model two of these stacks amplify a rounding: rwkv6-7b@tiny's seven random
layers grow a one-ulp difference about 1.5x a layer, and seamless's value
cotangents mostly round to zero or one e4m3 subnormal step at the fp8
cast, so a small difference upstream flips whole steps.  The reference
compiled with excess precision on (a legal compilation of the same
program) differs from itself there by more than the tolerances: up to 51%
on rwkv6's gradient leaves and 9.5% on seamless's cross ``wv`` and encoder.
A whole-model value is therefore held to its tolerance or, where the
reference's two compilations differ by more, to that difference; the
layer-by-layer checks, whose inputs are identical, hold every layer to the
tolerances themselves.  ``tools/reference_spread.py`` reads the port at
0.13-0.38 times that difference on rwkv6's leaves past 2e-2 and 0.70-0.81
on seamless's; copies of the port with one deliberate fault, each with its
loss within 1e-3, read 0.93-4.80 (rwkv6's bonus ``u`` 2% high: 52 of 54
leaves over 1), 2.47-20.35 (seamless's encoder causal: 25 of 25) and
7.47-27.32 (gemma3's window one short: 19 of 19), and fail the per-layer
checks too."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_intra_op_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import train_loop as JTL  # noqa: E402
from repro_torch import convert as CV  # noqa: E402
from repro_torch.configs import registry as PR  # noqa: E402
from repro_torch.core import kv_cache as PKV  # noqa: E402
from repro_torch.kernels import quant_attention as QA  # noqa: E402
from repro_torch.launch import train as PLT  # noqa: E402
from repro_torch.models import attention as PA  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.training import optimizer as PO  # noqa: E402
from repro_torch.training import train_loop as PTL  # noqa: E402

STRICT = {"xla_allow_excess_precision": False}
KEY = jax.random.PRNGKey(0)
HIDDEN_REL_L2 = 1e-2
AUX_REL = 1e-3
LOSS_REL = 1e-3
GRAD_REL_L2 = 2e-2
B = 2
# case -> (arch, T)
CASES = {"gemma3": ("gemma3-27b@reduced", 40),
         "rwkv6": ("rwkv6-7b@tiny", 32),
         "jamba": ("jamba-1.5-large-398b@reduced", 32),
         "jamba-t28": ("jamba-1.5-large-398b@reduced", 28),
         "seamless": ("seamless-m4t-large-v2@reduced", 32),
         "qwen2vl": ("qwen2-vl-2b@reduced", 32)}
ARCHS = sorted({arch for arch, _ in CASES.values()})


def _rel_l2(a, b) -> float:
    a = np.asarray(jnp.asarray(a, jnp.float32), np.float64)
    b = b.detach().float().numpy().astype(np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def _paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in flat]


def _batch(cfg, T: int, seed: int = 0):
    """(reference batch, port batch) from numpy: tokens, or N(0, 1) x 0.02
    ``embeds`` for a vision model; an encoder-decoder adds N(0, 1)
    ``src_embeds`` of T // 4 frames."""
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    mask = (rng.random((B, T)) > 0.2).astype(np.float32)
    arrays = {"labels": lab, "mask": mask}
    if cfg.frontend == "vision":
        arrays["embeds"] = (rng.normal(size=(B, T, cfg.d_model)) * 0.02).astype(np.float32)
    else:
        arrays["tokens"] = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    if cfg.is_encdec:
        arrays["src_embeds"] = rng.normal(size=(B, T // 4, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def _positions(T: int):
    return jnp.broadcast_to(jnp.arange(T)[None], (B, T))


def _reference_forward(jp, jcfg, jb):
    """The reference's train mode: each layer's input and output (its
    ``_apply_pattern`` layer by layer), the encoder's output (None for a
    decoder-only model), ``forward_hidden`` and ``forward_train``."""
    ctx = JT.StepCtx(jcfg)
    x = (JT.embed_tokens(jp, jcfg, jb["tokens"]) if "tokens" in jb
         else jb["embeds"].astype(jnp.bfloat16))
    positions = _positions(x.shape[1])
    enc = cross = None
    if jcfg.is_encdec:
        enc = JT.encode(jp, jcfg, jb["src_embeds"], _positions(jb["src_embeds"].shape[1]), ctx)
        cross = JT.build_cross_caches(jp, jcfg, enc)
    ins, outs = [], []
    for si, (patterns, count) in enumerate(jcfg.layer_plan()):
        for li in range(count):
            for pi, pat in enumerate(patterns):
                pp = jax.tree.map(lambda a, li=li: a[li], jp["stacks"][si][pi])
                cr = (None if cross is None
                      else jax.tree.map(lambda a, li=li: a[li], cross[si][pi]))
                ins.append(x)
                x, _, _ = JT._apply_pattern(x, pp, jcfg, pat, "train", positions, None, cr,
                                            None, None, ctx)
                outs.append(x)
    hidden, aux = JT.forward_hidden(jp, jcfg, jb, ctx)
    logits, aux2 = JT.forward_train(jp, jcfg, jb, ctx)
    return {"ins": ins, "outs": outs, "enc": enc, "hidden": hidden, "aux": aux,
            "logits": logits, "aux2": aux2}


def _layers(cfg):
    """(stack, layer, pattern index, pattern) of every decoder layer, in order."""
    return [(si, li, pi, pat) for si, (patterns, count) in enumerate(cfg.layer_plan())
            for li in range(count) for pi, pat in enumerate(patterns)]


def _cotangent(shape, seed: int) -> np.ndarray:
    return (np.random.default_rng(100 + seed).normal(size=shape) * 1e-2).astype(np.float32)


AUX_COT = np.array([0.01, 0.001], np.float32)    # the loss's weights on the MoE aux


def _reference_layer_vjps(jp, jcfg, ins, enc, src):
    """``jax.vjp`` of every train-mode decoder layer at its own input
    ``ins[i]`` (an encoder-decoder's layer building its cross cache from
    ``enc`` inside, so the cache's gradient reaches ``wk``, ``wv`` and
    ``enc``), and of every encoder layer with ``enc_norm`` at ``src``:
    [(output, aux, gradients)].  One compilation a layer pattern, run for
    each of its layers."""
    ctx = JT.StepCtx(jcfg)
    fns = {}

    def compiled(pat, *args):
        if pat not in fns:
            def vjp(pp, x, e, cot, pat=pat):
                def layer(pp, x, e):
                    cr = None if e is None else JA.build_cross_cache(e, pp["cross"], jcfg)
                    y, _, aux = JT._apply_pattern(x, pp, jcfg, pat, "train",
                                                  _positions(x.shape[1]), None, cr, None,
                                                  None, ctx)
                    return y, aux
                (y, aux), back = jax.vjp(layer, pp, x, e)
                return y, aux, back((cot, jnp.asarray(AUX_COT)))
            fns[pat] = jax.jit(vjp).lower(*args).compile(STRICT)
        return fns[pat](*args)
    res = []
    for i, (si, li, pi, pat) in enumerate(_layers(jcfg)):
        pp = jax.tree.map(lambda a, li=li: a[li], jp["stacks"][si][pi])
        cot = jnp.asarray(_cotangent(ins[i].shape, i), jnp.bfloat16)
        res.append(compiled(pat, pp, ins[i], enc, cot))
    if jcfg.encoder_layers:
        enc_vjp = jax.jit(lambda sub, x, cot: jax.vjp(
            lambda p, x: JT.encode(p, jcfg, x, _positions(x.shape[1]), ctx), sub, x)[1](cot))
    for li in range(jcfg.encoder_layers):
        sub = {"encoder": jax.tree.map(lambda a, li=li: a[li:li + 1], jp["encoder"]),
               "enc_norm": jp["enc_norm"]}
        cot = jnp.asarray(_cotangent(src.shape, 50 + li), jnp.bfloat16)
        if li == 0:
            enc_vjp = enc_vjp.lower(sub, src, cot).compile(STRICT)
        y = JT.encode(sub, jcfg, src, _positions(src.shape[1]), ctx)
        res.append((y, None, enc_vjp(sub, src, cot)))
    return res


def _port_layer_vjps(pp, cfg, ins, enc, src):
    """The port's counterpart of ``_reference_layer_vjps`` (autograd of
    ``transformer._train_layer`` and of a one-layer ``encode``), on the
    same inputs and cotangents."""
    ctx = PT.StepCtx(cfg)
    res = []

    def grads(outs, cots, leaves):
        live = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
        g = torch.autograd.grad([o for o, _ in live], leaves, [c for _, c in live],
                                allow_unused=True)
        return [torch.zeros_like(t) if d is None else d for t, d in zip(leaves, g)]
    for i, (si, li, pi, pat) in enumerate(_layers(cfg)):
        sl = PT.layer_slice(pp["stacks"][si][pi], li)
        leaves = [t.detach().clone().requires_grad_(True) for t in PO.leaves(sl)]
        lp = PO.unflatten(sl, leaves)
        x = CV.to_tensor(ins[i]).requires_grad_(True)
        e = None if enc is None else CV.to_tensor(enc).requires_grad_(True)
        cross = None if e is None else PA.cross_cache_train(e, lp["cross"], cfg, ctx.dispatch)
        y, aux = PT._train_layer(x, lp, cfg, pat, _positions_t(x.shape[1]), ctx, cross)
        cot = torch.from_numpy(_cotangent(tuple(x.shape), i)).to(torch.bfloat16)
        g = grads((y, aux), (cot, torch.from_numpy(AUX_COT)),
                  leaves + [x] + ([] if e is None else [e]))
        res.append((y, aux, g))
    one = dataclasses.replace(cfg, encoder_layers=1)
    for li in range(cfg.encoder_layers):
        sub = {"encoder": PT.layer_slice(pp["encoder"], slice(li, li + 1)),
               "enc_norm": pp["enc_norm"]}
        leaves = [t.detach().clone().requires_grad_(True) for t in PO.leaves(sub)]
        x = CV.to_tensor(src).requires_grad_(True)
        y = PT.encode(PO.unflatten(sub, leaves), one, x, ctx.dispatch)
        cot = torch.from_numpy(_cotangent(tuple(x.shape), 50 + li)).to(torch.bfloat16)
        res.append((y, None, grads((y,), (cot,), leaves + [x])))
    return res


def _positions_t(T: int):
    return torch.arange(T)[None].expand(B, T)


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


@pytest.fixture(scope="module")
def reference(models):
    """case -> {"strict": (forward, value_and_grad under remat) compiled
    with excess precision off, "alt": the same compiled with it on (the
    reference's own spread; compiled at the first call that needs it),
    "layers": ``_reference_layer_vjps``}."""
    done = {}

    def get(case):
        if case not in done:
            arch, T = CASES[case]
            _cfg, jp, _pp = models(arch)
            jcfg = JR.get(arch)
            jb, _pb = _batch(jcfg, T)
            ctx = JT.StepCtx(jcfg, remat=True)
            vg = jax.value_and_grad(lambda p, b: JTL.loss_fn(p, jcfg, b, ctx), has_aux=True)
            both = jax.jit(lambda p, b: (_reference_forward(p, jcfg, b), vg(p, b)))
            low = both.lower(jp, jb)
            res = {"strict": low.compile(STRICT)(jp, jb),
                   "alt": functools.lru_cache(maxsize=1)(
                       lambda low=low, jp=jp, jb=jb: low.compile()(jp, jb))}
            fwd = res["strict"][0]
            src = None if "src_embeds" not in jb else jb["src_embeds"].astype(jnp.bfloat16)
            res["layers"] = _reference_layer_vjps(jp, jcfg, fwd["ins"], fwd["enc"], src)
            res["src"] = src
            done[case] = res
        return done[case]
    return get


@pytest.fixture(scope="module")
def port_grads(models):
    """case -> the port's ``value_and_grad`` with and without remat."""
    done = {}

    def get(case):
        if case not in done:
            arch, T = CASES[case]
            cfg, _jp, pp = models(arch)
            _jb, pb = _batch(cfg, T)
            done[case] = tuple(PTL.value_and_grad(pp, cfg, pb, PT.StepCtx(cfg, remat=r))
                               for r in (True, False))
        return done[case]
    return get


def _held(ref, alt, got, tol: float) -> bool:
    """``got`` within ``tol`` of the reference's value, or within the
    reference's own spread (``alt()``: the value its excess-precision
    compilation gives) where that is larger."""
    err = _rel_l2(ref, got)
    if err <= tol:
        return True
    return err <= _rel_l2(ref, torch.from_numpy(np.asarray(jnp.asarray(alt(), jnp.float32))))


@pytest.mark.parametrize("arch", ARCHS)
def test_float_tree_matches_reference(arch, models):
    """The port's own float tree has the reference's keys, nesting, shapes
    and dtypes (the encoder, ``enc_norm``, cross, mamba and rwkv leaves
    included); the converted tree carries every leaf byte for byte."""
    cfg, jp, conv = models(arch)
    own = PT.init_params(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    ref = _paths(jp)
    assert len(ref) == len(PO.leaves(own)) == len(PO.leaves(conv))
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    for (path, a), o, c in zip(ref, PO.leaves(own), PO.leaves(conv)):
        assert tuple(o.shape) == a.shape and o.dtype == dtypes[a.dtype.name], path
        assert CV.to_numpy(c).tobytes() == a.tobytes(), path
    kinds = {p.kind for pats, _ in cfg.layer_plan() for p in pats}
    layer = own["stacks"][0]
    if cfg.is_encdec:
        assert {"encoder", "enc_norm"} <= set(own) and "cross" in layer[0]
    if "rwkv" in kinds:
        assert "tm" in layer[0]
    if "mamba" in kinds:
        assert any("mamba" in pat for pat in layer)


@pytest.mark.parametrize("case", CASES)
def test_layers_and_their_backward_match_reference(case, models, reference):
    """Every decoder layer (and encoder layer) on the reference's own input
    to it: the output (``HIDDEN_REL_L2``), the MoE aux (``AUX_REL``) and,
    under one cotangent, every parameter gradient and the input's
    (``GRAD_REL_L2``); a seamless layer builds its quantized cross cache
    from the encoder's output inside, so ``wk``, ``wv`` and the encoder
    output's gradient pass through the int8 rounding and the fp8 cast."""
    arch, _T = CASES[case]
    cfg, _jp, pp = models(arch)
    ref = reference(case)
    fwd = ref["strict"][0]
    mine = _port_layer_vjps(pp, cfg, fwd["ins"], fwd["enc"], ref["src"])
    assert len(mine) == len(ref["layers"]) == cfg.num_layers + cfg.encoder_layers
    for i, ((jy, jaux, jg), (py, paux, pg)) in enumerate(zip(ref["layers"], mine)):
        assert _rel_l2(jy, py) < HIDDEN_REL_L2, i
        if jaux is not None:
            np.testing.assert_allclose(np.asarray(jaux), paux.detach().numpy(),
                                       rtol=AUX_REL, atol=1e-6)
        flat = _paths(jg)
        assert len(flat) == len(pg), i
        for (path, a), b in zip(flat, pg):
            assert (not a.any()) == (not bool(b.any())), (i, path)
            assert _rel_l2(a, b) < GRAD_REL_L2, (i, path)


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_reference(case, models, reference):
    """The whole train-mode forward: every layer's output, the normed hidden
    state and the logits (``HIDDEN_REL_L2``, or the reference's own spread
    where larger), and the MoE aux pair."""
    arch, T = CASES[case]
    cfg, _jp, pp = models(arch)
    ref = reference(case)
    fwd = ref["strict"][0]

    def alt(key, i=None):
        out = ref["alt"]()[0][key]
        return out if i is None else out[i]
    _jb, pb = _batch(cfg, T)
    outs = []
    with torch.no_grad():
        ph, paux = PT.forward_hidden(pp, cfg, pb, collect=outs)
        plogits, paux2 = PT.forward_train(pp, cfg, pb)
    assert len(outs) == len(fwd["outs"]) == cfg.num_layers
    for i, (a, b) in enumerate(zip(fwd["outs"], outs)):
        assert _held(a, lambda i=i: alt("outs", i), b, HIDDEN_REL_L2), i
    assert _held(fwd["hidden"], lambda: alt("hidden"), ph, HIDDEN_REL_L2)
    assert plogits.dtype == torch.float32
    assert _held(fwd["logits"], lambda: alt("logits"), plogits, HIDDEN_REL_L2)
    for ja, pa in ((fwd["aux"], paux), (fwd["aux2"], paux2)):
        np.testing.assert_allclose(np.asarray(ja), pa.numpy(), rtol=AUX_REL, atol=1e-6)
    if cfg.num_experts:
        assert float(paux[0]) > 0.5 and float(paux[1]) > 0


@pytest.mark.parametrize("case", CASES)
def test_loss_and_grads_match_reference(case, models, reference, port_grads):
    """One step's loss and MoE terms (``LOSS_REL``) and every gradient leaf
    against ``jax.value_and_grad`` under remat, in the leaf's dtype
    (``GRAD_REL_L2``, or the reference's own spread where larger); a leaf
    all zero on one side is all zero on the other (qwen2-vl's
    ``embedding``, which ``embeds`` batches bypass)."""
    arch, _T = CASES[case]
    cfg, _jp, pp = models(arch)
    ref = reference(case)
    (jtotal, jm), jg = ref["strict"][1]
    ((ptotal, pm), pg), _ = port_grads(case)

    def alt(j):
        return _paths(ref["alt"]()[1][1])[j][1]
    for k in ("loss", "moe_lb", "moe_z"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=LOSS_REL, atol=1e-6)
    np.testing.assert_allclose(float(ptotal), float(jtotal), rtol=LOSS_REL)
    zeros = []
    for j, ((path, a), b, leaf) in enumerate(zip(_paths(jg), PO.leaves(pg), PO.leaves(pp))):
        assert b.dtype == leaf.dtype, path
        assert (not a.any()) == (not bool(b.any())), path
        if not a.any():
            zeros.append(path)
            continue
        assert _held(a, lambda j=j: alt(j), b, GRAD_REL_L2), path
    assert zeros == (["['embedding']"] if cfg.frontend == "vision" else []), zeros


@pytest.mark.parametrize("case", CASES)
def test_remat_is_bitwise(case, port_grads):
    """``torch.utils.checkpoint`` per layer (and per encoder layer) changes
    no bit of the loss or of any gradient."""
    ((rtotal, _), rg), ((ntotal, _), ng) = port_grads(case)
    assert float(rtotal) == float(ntotal)
    assert all(torch.equal(a, b) for a, b in zip(PO.leaves(rg), PO.leaves(ng)))


@pytest.mark.parametrize("arch", ARCHS)
def test_optimizer_step_moves_every_leaf(arch, models):
    """One AdamW step (``default_opt_for``'s, past its warmup: at its first
    warmup step the learning rate is 3e-6, below a bf16 leaf's rounding):
    every leaf with a gradient moves; a leaf without one (qwen2-vl's
    ``embedding``) takes the decoupled weight decay alone; the gradient
    norm and every new leaf are finite."""
    cfg, _jp, pp = models(arch)
    T = next(t for a, t in CASES.values() if a == arch)
    _jb, pb = _batch(cfg, T, seed=1)
    opt = dataclasses.replace(PTL.default_opt_for(cfg), lr=1e-2, warmup_steps=1)
    (_, _), grads = PTL.value_and_grad(pp, cfg, pb, PT.StepCtx(cfg))
    new, state, m = PTL.make_train_step(cfg, opt)(pp, PO.init_state(opt, pp), pb)
    assert opt.kind == "adamw" and int(state["step"]) == 1
    assert np.isfinite(float(m["grad_norm"]))
    lr = PO.lr_schedule(opt, 1)          # the first update's: step 0 + 1
    for a, b, g in zip(PO.leaves(new), PO.leaves(pp), PO.leaves(grads)):
        assert bool(torch.isfinite(a).all())
        if g.any():
            assert not torch.equal(a, b)
        else:
            decayed = (b.float() - lr * opt.weight_decay * b.float()).to(b.dtype)
            assert torch.equal(a, decayed)


def test_cross_grads_pin_key_rounding_and_fp8_cotangent(models, reference):
    """seamless's cross ``wk`` and ``wv`` gradients on the reference's own
    decoder input and encoder output equal the reference's
    (``GRAD_REL_L2``), in every decoder layer.  ``wk`` reaches the loss
    only through the keys' scale and zero (the int8 rounding passes
    nothing), so its gradient is far smaller than ``wv``'s.  ``wv``'s
    cotangent is rounded to e4m3 on its way back through the fp8 cast, as
    XLA's is: a straight-through cast (the fp8 values forward, an identity
    backward) misses the reference by more than the tolerance."""
    cfg, _jp, pp = models(CASES["seamless"][0])
    ref = reference("seamless")
    fwd = ref["strict"][0]
    n = len(PO.leaves(PT.layer_slice(pp["stacks"][0][0], 0)))
    names = [p for p, _ in _paths(ref["layers"][0][2][0])]
    wk, wv = names.index("['cross']['wk']['w']"), names.index("['cross']['wv']['w']")
    mine = _port_layer_vjps(pp, cfg, fwd["ins"], fwd["enc"], ref["src"])
    cast = PKV.cast_values

    def straight_through(v, dtype):
        return v + (cast(v, dtype).to(v.dtype) - v).detach()
    PKV.cast_values = straight_through
    try:
        through = _port_layer_vjps(pp, cfg, fwd["ins"], fwd["enc"], ref["src"])
    finally:
        PKV.cast_values = cast
    for i in range(cfg.num_layers):
        jg = [a for _, a in _paths(ref["layers"][i][2])]
        pg, sg = mine[i][2], through[i][2]
        assert len(pg) == n + 2
        for j in (wk, wv):
            assert _rel_l2(jg[j], pg[j]) < GRAD_REL_L2, (i, names[j])
        assert float(pg[wk].float().norm()) < 0.5 * float(pg[wv].float().norm())
        assert _rel_l2(jg[wv], sg[wv]) > GRAD_REL_L2, i


@pytest.mark.parametrize("arch", ("seamless-m4t-large-v2@reduced", "qwen2-vl-2b@reduced"))
def test_launcher_frontend_batches(arch):
    """The launcher's batches carry the reference launcher's keys and
    shapes: ``src_embeds`` zeros [B, seq // 4, d] beside the tokens, or
    ``embeds`` N(0, 1) x 0.02 [B, seq, d] and no ``tokens``, a draw a step."""
    cfg = PR.get(arch)
    base = {"tokens": torch.zeros((4, 64), dtype=torch.int32),
            "labels": torch.zeros((4, 64), dtype=torch.int32),
            "mask": torch.ones((4, 64))}
    b1, b2 = (PLT.frontend_batch(cfg, dict(base), 0, step) for step in (1, 2))
    if cfg.is_encdec:
        assert set(b1) == {"tokens", "labels", "mask", "src_embeds"}
        assert b1["src_embeds"].shape == (4, 16, cfg.d_model)
        assert b1["src_embeds"].dtype == torch.bfloat16 and not b1["src_embeds"].any()
    else:
        assert set(b1) == {"embeds", "labels", "mask"}
        e = b1["embeds"].float()
        assert b1["embeds"].dtype == torch.bfloat16 and e.shape == (4, 64, cfg.d_model)
        assert abs(float(e.std()) - 0.02) < 0.002 and abs(float(e.mean())) < 0.002
        assert not torch.equal(b1["embeds"], b2["embeds"])


@pytest.mark.parametrize("arch", ("seamless-m4t-large-v2@reduced", "qwen2-vl-2b@reduced"))
def test_launch_train_frontends_on_cpu(arch, capsys):
    """``python -m repro_torch.launch.train --device cpu --steps 2`` trains
    the encoder-decoder and the vision model to a finite loss."""
    out = PLT.main(["--arch", arch, "--device", "cpu", "--steps", "2", "--batch", "2",
                    "--seq", "32"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert "[train] done: loss" in capsys.readouterr().out


def test_decode_function_backward_is_plain_autograd_on_cpu():
    """``QuantDecodeAttentionFunction`` on the CPU (its forward is the
    wrapper, which takes the plain version there) over a cache from
    ``quantized_cache``: the output and the gradients of q, the keys'
    scale and zero and the fp8 values equal autograd of the plain version,
    with every input requiring grad and with q alone frozen."""
    g = torch.Generator().manual_seed(0)
    k = torch.randn((2, 12, 2, 64), generator=g).to(torch.bfloat16)
    v = (0.1 * torch.randn((2, 12, 2, 64), generator=g)).to(torch.bfloat16)
    q = (torch.randn((2, 8, 64), generator=g) / 8).to(torch.bfloat16)
    for q_grad in (True, False):
        outs = []
        for use_fn in (True, False):
            kk, vv = k.clone().requires_grad_(True), v.clone().requires_grad_(True)
            qq = q.clone().requires_grad_(q_grad)
            c = PKV.quantized_cache(kk, vv)
            assert c.v.dtype == torch.float8_e4m3fn and c.v.requires_grad
            args = (qq, c.k_q, c.k_scale, c.k_zero, c.v, c.length)
            y = (QA.QuantDecodeAttentionFunction.apply(*args, 8) if use_fn
                 else QA.quant_decode_attention_plain(*args))
            y.backward(torch.randn(y.shape, generator=torch.Generator().manual_seed(1)))
            outs.append((y.detach(), kk.grad, vv.grad, qq.grad))
        (ya, ka, va, qa), (yb, kb, vb, qb) = outs
        assert torch.equal(ya, yb) and torch.equal(ka, kb) and torch.equal(va, vb)
        assert (qa is None) == (not q_grad) and (qa is None or torch.equal(qa, qb))
        assert ka.abs().sum() > 0 and va.abs().sum() > 0
