"""The port's configuration counts, dry run, roofline and profiler summary,
held to the JAX package where it has a counterpart.

* ``ModelConfig.param_count`` / ``active_param_count``, ``INPUT_SHAPES``,
  ``ASSIGNED`` and ``analysis.roofline.model_flops`` equal the reference's
  for every architecture and every ``ASSIGNED x INPUT_SHAPES`` pair.
* Every pair builds its meta-device case or carries the reference's skip
  reason (the counterpart of ``tests/test_system.py``'s case checks), with
  the reference's arguments apart from the parameters' packed layout;
  ``abstract_params`` leaves equal ``init_params``' in shape, dtype and
  packed-carrier metadata at ``@tiny``.
* The dry-run CLI runs the 40 cases with ``--device-memory`` (7 skips, no
  failure) and refuses to guess a capacity without a card.
* ``analysis.trace.summarize`` on stub profiler events gives the fields
  ``chip_smoke.py``'s ``[profile]`` lines print, and ``device_ms`` sums
  stub kineto events as its training profiles read them; ``decode_step_bound``
  equals a hand count at ``@tiny``.
* ``models.shard_util`` and ``launch.mesh``: the one-card layout."""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_intra_op_thread  # noqa: E402,F401

from repro.analysis import roofline as JRL  # noqa: E402
from repro.configs import base as JB  # noqa: E402
from repro.configs import registry as JR  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro_torch.analysis import fill_experiments as FE  # noqa: E402
from repro_torch.analysis import roofline as RL  # noqa: E402
from repro_torch.analysis import trace as TR  # noqa: E402
from repro_torch.configs import base as PB  # noqa: E402
from repro_torch.configs import registry as PR  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import mesh as PM  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.models import shard_util as SU  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.runtime import plan as RP  # noqa: E402

PAIRS = [(a, s) for a in JR.ASSIGNED for s in JB.INPUT_SHAPES]


def test_registry_and_shapes_equal_reference():
    assert list(PR.ASSIGNED) == list(JR.ASSIGNED)
    assert list(PR.ARCHS) == list(JR.ARCHS)
    assert {k: dataclasses.astuple(v) for k, v in PB.INPUT_SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JB.INPUT_SHAPES.items()}


@pytest.mark.parametrize("arch", list(JR.ARCHS))
def test_param_counts_equal_reference(arch):
    for variant in ("", "@reduced", "@tiny"):
        cfg, jcfg = PR.get(arch + variant), JR.get(arch + variant)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        assert type(cfg.active_param_count()) is int


def test_model_flops_equal_reference():
    for arch, shape in PAIRS:
        assert RL.model_flops(arch, shape) == JRL.model_flops(arch, shape), (arch, shape)


def _arg_shapes(tree):
    """(shape, dtype name) of every JAX ShapeDtypeStruct or torch tensor of
    a non-parameter argument, in the reference's leaf order."""
    import jax
    if isinstance(tree, torch.Tensor):
        return [(tuple(tree.shape), str(tree.dtype).replace("torch.", ""))]
    return [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("arch", list(JR.ASSIGNED))
def test_every_case_builds_or_carries_the_reference_skip(arch):
    cfg, jcfg = PR.get(arch), JR.get(arch)
    for name, shape in PB.INPUT_SHAPES.items():
        jshape = JB.INPUT_SHAPES[name]
        reason = SP.skip_reason(cfg, shape)
        assert reason == JSP.skip_reason(jcfg, jshape)
        if reason:
            continue
        case = SP.build_case(cfg, shape)
        assert case.kind == shape.kind and case.name == f"{cfg.name}:{name}"
        assert all(t.device.type == "meta" for t in SP.tensors(case.args))
        jcase = JSP.build_case(jcfg, jshape)
        assert len(case.args) == len(jcase.args)
        if shape.kind == "train":
            assert case.static == jcase.static
            assert _arg_shapes(case.args[2]["labels"]) == _arg_shapes(jcase.args[2]["labels"])
            assert sorted(case.args[2]) == sorted(jcase.args[2])
            for k in case.args[2]:
                assert _arg_shapes(case.args[2][k]) == _arg_shapes(jcase.args[2][k])
        else:
            # the inputs after the parameters (and the decode cache)
            rest = [1] + list(range(3 if shape.kind == "decode" else 2, len(case.args)))
            for i in rest:
                assert _arg_shapes(case.args[i]) == _arg_shapes(jcase.args[i]), (name, i)
        if shape.kind == "decode":
            # the dense cache: the reference's key, scale, zero and value leaves
            import jax
            jleaves = [x for x in jax.tree.leaves(jcase.args[2]) if len(x.shape) > 1]
            leaves = [t for t in SP.tensors(case.args[2]) if t.dim() > 1]
            assert sorted(tuple(t.shape) for t in leaves) == \
                sorted(tuple(x.shape) for x in jleaves)


def _carriers(tree, path=()):
    """(path, kind, shape, dtype) of every leaf, packed linears with their
    class, bits and logical dims."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _carriers(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _carriers(v, path + (i,))
    elif isinstance(tree, RP.PackedLinear):
        yield path, type(tree).__name__, tree.bits, tree.k, tree.n
        for f in ("data", "scale", "zero"):
            t = getattr(tree, f)
            yield path + (f,), tuple(t.shape), t.dtype
    else:
        yield path, tuple(tree.shape), tree.dtype


@pytest.mark.parametrize("arch", ["qwen2-7b@tiny", "moonshot-v1-16b-a3b@tiny-moe",
                                  "jamba-1.5-large-398b@tiny", "rwkv6-7b@tiny",
                                  "seamless-m4t-large-v2@tiny", "gemma3-27b@tiny",
                                  "qwen2-7b@tiny g128 int8"])
@pytest.mark.parametrize("quantized", [True, False])
def test_abstract_params_match_init_params(arch, quantized):
    """Including weight groups of 128 and 8-bit weights (the packed
    carriers' layout computed from the dims, not quantized)."""
    name, _, variant = arch.partition(" ")
    cfg = PR.get(name)
    if variant:
        cfg = dataclasses.replace(cfg, quant=dataclasses.replace(
            cfg.quant, group_size=128, weight_bits=8, act_bits=16))
    real = T.init_params(cfg, torch.Generator().manual_seed(0), torch.device("cpu"),
                         quantized=quantized)
    abstract = T.abstract_params(cfg, quantized=quantized)
    assert list(_carriers(abstract)) == list(_carriers(real))
    assert all(t.device.type == "meta" for _p, t in RP.tree_leaves_with_path(abstract))


def test_abstract_builder_draws_nothing(monkeypatch):
    def no_draw(*a, **k):
        raise AssertionError("the abstract tree drew a random number")
    monkeypatch.setattr(torch, "randn", no_draw)
    T.abstract_params(PR.get("qwen2-7b@tiny"), quantized=True)
    with pytest.raises(ValueError, match="meta"):
        T.init_params(PR.get("qwen2-7b@tiny"), None, torch.device("cpu"))


@pytest.fixture(scope="module")
def dryrun_records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    recs = DR.main(["--all", "--device-memory", "80000000000", "--out", str(out)])
    return out, recs


def test_dryrun_cli_runs_every_case(dryrun_records, monkeypatch):
    out, recs = dryrun_records
    assert len(recs) == 40 and not [r for r in recs if r["status"] == "FAIL"]
    skips = sorted(r["arch"] for r in recs if r["status"] == "SKIP")
    assert skips == sorted(a for a in JR.ASSIGNED
                           if not JR.get(a).sub_quadratic)
    assert all(r["shape"] == "long_500k" for r in recs if r["status"] == "SKIP")
    assert len(list(out.glob("*.json"))) == 40
    ok = [r for r in recs if r["status"] == "OK"]
    assert all(r["fits"] == (r["argument_bytes"] <= 80_000_000_000) for r in ok)
    assert all(r["temp_bytes"] == "not measured" and r["n_chips"] == 1 for r in ok)
    # the argument bytes are the case's tree, leaf by leaf
    r = next(r for r in ok if r["arch"] == "glm4-9b" and r["shape"] == "decode_32k")
    case = SP.build_case(PR.get("glm4-9b"), PB.INPUT_SHAPES["decode_32k"])
    assert r["argument_bytes"] == sum(t.numel() * t.element_size()
                                      for t in SP.tensors(case.args))


def test_dryrun_refuses_to_guess_a_capacity(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        DR.main(["--arch", "glm4-9b", "--shape", "decode_32k", "--out", str(tmp_path)])
    assert e.value.code == 2
    assert not list(tmp_path.iterdir())


def test_roofline_and_tables_from_the_records(dryrun_records, capsys):
    out, recs = dryrun_records
    ok = [r for r in recs if r["status"] == "OK"]
    for rec in ok:
        r = RL.analyze_case(rec)
        assert r.collective_s == 0.0 and r.chips == 1
        assert r.memory_s == rec["argument_bytes"] / RL.HBM_BYTES_PER_S
        peak = RL.PEAK_OPS_PER_S["f32" if rec["kind"] == "train" else "int8"]
        assert r.compute_s == JRL.model_flops(rec["arch"], rec["shape"]) / peak
        assert r.bound_s == max(r.compute_s, r.memory_s)
    text = FE.main([str(out)])
    assert capsys.readouterr().out.strip() == text.strip()
    table = RL.render_table(str(out))
    assert table in text and table.count("\n") == 41
    assert "**33 OK, 7 SKIP, 0 FAIL**" in text
    assert sorted(p.name for p in out.iterdir()) == sorted(
        DR.case_id(a, s) + ".json" for a, s in PAIRS)


def _kineto(name, ns, device):
    return types.SimpleNamespace(name=lambda: name, duration_ns=lambda: ns,
                                 device_type=lambda: device)


def _profile(events):
    """A finished profiler run's stand-in: ``events`` as its kineto events."""
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


def test_trace_summary_from_stub_events():
    from torch.autograd import DeviceType
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = []
    for name, count, us, device in (("void w4a8_kernel<4, 16>(...)", 8, 3000, cuda),
                                    ("rmsnorm_kernel(float const*)", 10, 200, cuda),
                                    ("paged_decode_kernel<128>", 4, 800, cuda),
                                    ("elementwise_kernel", 100, 2000, cuda),
                                    ("cudaGraphLaunch", 2, 600, cpu),
                                    ("cudaMemcpyAsync", 4, 40, cpu),
                                    ("aten::mm", 3, 900, cpu)):
        events += [_kineto(name, us * 1000 // count, device) for _ in range(count)]
    out = TR.summarize(_profile(events), steps=2, wall_us=12000.0)
    assert out["device_busy_share"] == 6000.0 / 12000.0
    assert out["profiled_step_ms"] == 6.0
    assert out["device_ms_per_step"] == 3.0
    assert out["port_kernel_ms_per_step"] == 2.0
    assert out["device_launches_per_step"] == 61.0
    assert [k["name"] for k in out["top_kernels"]] == [
        "void w4a8_kernel<4, 16>(...)", "elementwise_kernel",
        "paged_decode_kernel<128>", "rmsnorm_kernel(float const*)"]
    assert out["port_kernels"] == {
        "w4a8_kernel": {"ms_per_step": 1.5, "launches_per_step": 4.0},
        "paged_decode_kernel": {"ms_per_step": 0.4, "launches_per_step": 2.0},
        "rmsnorm_kernel": {"ms_per_step": 0.1, "launches_per_step": 5.0}}
    assert out["runtime_calls"] == {
        "cudaGraphLaunch": {"host_ms_per_step": 0.3, "calls_per_step": 1.0},
        "cudaMemcpyAsync": {"host_ms_per_step": 0.02, "calls_per_step": 2.0}}
    assert TR.summarize(_profile([_kineto("cudaLaunchKernel", 5000, cpu)]), 1,
                        100.0) == {"device_busy_share": "not measured"}


def test_trace_device_ms_from_stub_kineto_events():
    """``device_ms`` sums the CUDA events of a profiled run and those whose
    name holds each symbol, in ms; host events count nowhere."""
    from torch.autograd import DeviceType
    events = [_kineto("rmsnorm_kernel(float const*)", 2_000_000, DeviceType.CUDA),
              _kineto("void flash_prefill_kernel<128>", 3_500_000, DeviceType.CUDA),
              _kineto("rmsnorm_kernel(float const*)", 500_000, DeviceType.CUDA),
              _kineto("Memset (Device)", 250_000, DeviceType.CUDA),
              _kineto("rmsnorm_kernel launch", 9_000_000, DeviceType.CPU)]
    prof = _profile(events)
    total, by = TR.device_ms(prof, ("rmsnorm_kernel", "flash_prefill_kernel",
                                    "dense_decode_kernel"))
    assert total == 6.25
    assert by == {"rmsnorm_kernel": 2.5, "flash_prefill_kernel": 3.5,
                  "dense_decode_kernel": 0.0}
    assert TR.device_ms(prof) == (6.25, {})


def _packed_bytes(k, n, bits):
    kp, np_ = -(-k // 128) * 128, -(-n // 256) * 256
    return kp * (np_ // 2 if bits == 4 else np_) + 2 * 4 * np_


def test_decode_step_bound_by_hand():
    cfg = PR.get("qwen2-7b@tiny")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), torch.device("cpu"),
                           quantized=True)
    lens = [10, 37, 5]
    b = RL.decode_step_bound(cfg, params, rows=4, context_lens=lens)
    d, f, H, Hkv, D, L = 256, 512, 4, 2, 64, 6
    V = cfg.padded_vocab_size
    lin = [(d, H * D), (d, Hkv * D), (d, Hkv * D), (H * D, d), (d, f), (d, f), (f, d)]
    layer = sum(_packed_bytes(k, n, 4) for k, n in lin) + 2 * (H * D + 2 * Hkv * D) \
        + 2 * 4 * d                                   # bf16 biases, two f32 norms
    weights = L * layer + 4 * d + _packed_bytes(d, V, 8)
    kv = L * (sum(lens) + 3) * Hkv * (D + 8 + D)      # int8 codes, scale/zero, fp8 values
    acts = 4 * d * 2 + 4 * V * 4
    assert b.bytes == {"weights": weights, "experts": 0, "kv": kv, "state": 0,
                       "activations": acts}
    int8 = 2 * 4 * (L * sum(k * n for k, n in lin) + d * cfg.vocab_size)
    assert b.ops["int8"] == int8
    assert b.ops["bf16"] == L * 4 * sum(lens) * H * D
    assert b.ops["f32"] == (2 * L + 1) * 4 * 4 * d
    assert b.bound_by == "bytes"
    assert b.bound_s == (weights + kv + acts) / RL.HBM_BYTES_PER_S
    s = RL.shares(b.bound_s, 2 * b.bound_s, 4 * b.bound_s)
    assert s == {"device_share": 0.5, "wall_share": 0.25}
    assert RL.shares(1.0, None, 2.0)["device_share"] == "not measured"


def test_decode_step_bound_reads_only_the_routed_experts():
    cfg = PR.get("moonshot-v1-16b-a3b@tiny-moe")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), torch.device("cpu"),
                           quantized=True)
    E, K, L, d, f = cfg.num_experts, cfg.experts_per_tok, cfg.num_layers, 256, 512
    rng = np.random.default_rng(0)
    ids = [torch.from_numpy(rng.integers(0, E, (4, 1, K))) for _ in range(L)]
    b = RL.decode_step_bound(cfg, params, rows=4, context_lens=[3, 9, 4, 7],
                             expert_ids=ids)
    slab = 2 * _packed_bytes(d, f, 4) + _packed_bytes(f, d, 4)
    assert b.bytes["experts"] == slab * sum(len(set(i.reshape(-1).tolist())) for i in ids)
    router = d * E * 2
    dense = RL.decode_step_bound(dataclasses.replace(cfg, num_experts=0),
                                 {**params, "stacks": ()}, rows=4, context_lens=[])
    assert b.bytes["weights"] - dense.bytes["weights"] == L * (
        router + 2 * 4 * d + sum(_packed_bytes(k, n, 4) for k, n in (
            (d, cfg.num_heads * 64), (d, cfg.num_kv_heads * 64),
            (d, cfg.num_kv_heads * 64), (cfg.num_heads * 64, d))))
    assert b.ops["int8"] - dense.ops["int8"] == 2 * 4 * L * (
        K * 3 * d * f + sum(k * n for k, n in (
            (d, cfg.num_heads * 64), (d, cfg.num_kv_heads * 64),
            (d, cfg.num_kv_heads * 64), (cfg.num_heads * 64, d))))
    with pytest.raises(ValueError, match="expert ids"):
        RL.decode_step_bound(cfg, params, rows=4, context_lens=[3])
    with pytest.raises(ValueError, match="MoE layers"):
        RL.decode_step_bound(cfg, params, rows=4, context_lens=[3],
                             expert_ids=ids + ids[:1])


def test_one_card_layout():
    x = torch.ones(3)
    assert SU.current_mesh() is None and SU.constrain(x, "model", None) is x
    mesh = PM.make_host_mesh("cpu", 80_000_000_000)
    assert (mesh.axis_names, mesh.shape, mesh.size) == (("data", "model"), (1, 1), 1)
    assert mesh.memory_bytes == 80_000_000_000 and mesh.device.type == "cpu"
    with pytest.raises(ValueError, match="memory"):
        PM.make_host_mesh("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PM.make_host_mesh("cuda")
