"""Port parity: the Sentry, its policies and the admission pipeline
(``repro_torch.core``) against the reference's (``repro.core``).

Each program of ``tests/test_sentry.py`` and ``tests/test_admission_pool.py``
is paired with its torch twin: the scan of tanh, ``erf``, the matmul, a host
callback (a ``torch.library`` custom op with a fake registration, the
counterpart of ``jax.pure_callback``), that callback smuggled into a
``cond`` branch, a sort, and four control-flow programs whose bodies read a
tensor computed outside them (``cond``, ``while_loop``, ``scan`` and a
``cond`` nested in a ``cond``).  Both packages must reach the same verdict
under the legacy allowlist, the modern policy and the allowlist extended by
the program's own names; the products must cost the same FLOPs; and the
cache keys, budget refusals and interpret-equals-verify hold on both sides.
Other FLOP, byte and op counts differ with the op sets (one ``aten.sort``
against jax's sort plus projections) and are printed beside the
reference's, with no bound.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._higher_order_ops.scan import scan as torch_scan
from torch._higher_order_ops.while_loop import while_loop as torch_while

import repro.core as J
import repro_torch.core as T


@torch.library.custom_op("seepp_control_plane::leak", mutates_args=())
def _leak(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


@_leak.register_fake
def _(x):
    return torch.empty_like(x)


def _jax_evil(x):
    return jax.pure_callback(
        lambda v: v, jax.ShapeDtypeStruct(x.shape, x.dtype), x)


# ------------------------------------------------------------- programs

def _jax_scan(x):
    return jax.lax.scan(lambda c, t: (c + jnp.tanh(t), c * 2), 0.0, x)[0]


def _torch_scan(x):
    return torch_scan(lambda c, t: (c + torch.tanh(t), c * 2),
                      torch.zeros(()), x)[0]


def _jax_smuggle(x):
    return jax.lax.cond(x.sum() > 0, _jax_evil, lambda v: v, x)


def _torch_smuggle(x):
    return torch.cond(x.sum() > 0, lambda v: _leak(v), lambda v: v.clone(),
                      (x,))


def _matmul(a, b):
    return a @ b


# bodies that read y, computed outside them: both packages lift it into
# the control-flow operator's operands


def _jax_cond_closure(x):
    y = x * 2
    return jax.lax.cond(x.sum() > 0, lambda v: v + y, lambda v: v - y, x)


def _torch_cond_closure(x):
    y = x * 2
    return torch.cond(x.sum() > 0, lambda v: v + y, lambda v: v - y, (x,))


def _jax_while_closure(x):
    y = x * 2
    return jax.lax.while_loop(lambda c: c[0] < 3,
                              lambda c: (c[0] + 1, c[1] + y), (0, x))[1]


def _torch_while_closure(x):
    y = x * 2
    return torch_while(lambda i, c: i < 3, lambda i, c: (i + 1, c + y),
                       (torch.zeros((), dtype=torch.int64), x))[1]


def _jax_scan_closure(x):
    y = x.sum() * 2
    return jax.lax.scan(lambda c, t: (c + t * y, c), 0.0, x)[0]


def _torch_scan_closure(x):
    y = x.sum() * 2
    return torch_scan(lambda c, t: (c + t * y, c.clone()), torch.zeros(()),
                      x)[0]


def _jax_nested_cond(x):
    y = x * 2
    inner = lambda v: jax.lax.cond(v.sum() > 1, lambda u: u + y,
                                   lambda u: u * y, v)
    return jax.lax.cond(x.sum() > 0, inner, lambda v: v - y, x)


def _torch_nested_cond(x):
    y = x * 2
    inner = lambda v: torch.cond(v.sum() > 1, lambda u: u + y,
                                 lambda u: u * y, (v,))
    return torch.cond(x.sum() > 0, inner, lambda v: v - y, (x,))


X16 = np.linspace(-1.0, 1.0, 16, dtype=np.float32)
X4 = np.linspace(-1.0, 1.0, 4, dtype=np.float32)

#: name -> (reference fn, torch fn, numpy args, the names ``extended``
#: adds on each side)
PROGRAMS = {
    "scan_tanh": (_jax_scan, _torch_scan, (X16,),
                  (("scan",), ("higher_order.scan",))),
    "erf": (lambda x: jax.lax.erf(x).sum(),
            lambda x: torch.special.erf(x).sum(), (np.ones(4, np.float32),),
            (("erf",), ("aten.erf",))),
    "matmul": (_matmul, _matmul, (np.ones((32, 48), np.float32),
                                  np.ones((48, 16), np.float32)),
               ((), ())),
    "callback": (_jax_evil, lambda x: _leak(x), (np.ones(3, np.float32),),
                 (("pure_callback",), ("seepp_control_plane.leak",))),
    "callback_in_cond": (_jax_smuggle, _torch_smuggle,
                         (np.ones(3, np.float32),),
                         (("pure_callback",), ("seepp_control_plane.leak",))),
    "sort": (lambda x: jnp.sort(x), lambda x: torch.sort(x).values,
             (np.array([3, 1, 2, 5, 4], np.int32),), ((), ())),
    "cond_closure": (_jax_cond_closure, _torch_cond_closure, (X4,),
                     ((), ())),
    "while_closure": (_jax_while_closure, _torch_while_closure, (X4,),
                      ((), ())),
    "scan_closure": (_jax_scan_closure, _torch_scan_closure, (X4,),
                     (("scan",), ("higher_order.scan",))),
    "nested_cond": (_jax_nested_cond, _torch_nested_cond, (X4,), ((), ())),
}
CLOSURES = ("cond_closure", "while_closure", "scan_closure", "nested_cond")

#: the verdicts both packages must reach: (legacy, modern, extended)
EXPECTED = {
    "scan_tanh": (False, True, True),
    "erf": (False, True, True),
    "matmul": (True, True, True),
    "callback": (False, False, False),
    "callback_in_cond": (False, False, False),
    "sort": (True, True, True),
    "cond_closure": (True, True, True),
    "while_closure": (True, True, True),
    "scan_closure": (False, True, True),
    "nested_cond": (True, True, True),
}


def _policy(core, which, names):
    if which == "legacy":
        return core.LegacyFilterPolicy()
    if which == "modern":
        return core.ModernEmulationPolicy()
    return core.LegacyFilterPolicy().extended(*names)


def _verdict(core, fn, args, policy):
    try:
        core.AdmissionController().admit(fn, args, policy=policy)
        return True
    except core.SandboxViolation:
        return False


@pytest.mark.parametrize("which", ["legacy", "modern", "extended"])
@pytest.mark.parametrize("name", list(PROGRAMS))
def test_verdicts_match_reference(name, which):
    jfn, tfn, args, (jnames, tnames) = PROGRAMS[name]
    ref = _verdict(J, jfn, tuple(jnp.asarray(a) for a in args),
                   _policy(J, which, jnames))
    got = _verdict(T, tfn, tuple(torch.from_numpy(a) for a in args),
                   _policy(T, which, tnames))
    assert got == ref == EXPECTED[name][
        ("legacy", "modern", "extended").index(which)]


def _lifted_closures(node_operands, closure) -> int:
    return sum(1 for a in node_operands if a is closure)


@pytest.mark.parametrize("name", CLOSURES)
def test_control_flow_closures_are_lifted_as_operands(name):
    """The tensor a body reads from outside (the program's first product,
    ``y``) is an operand of the outermost control-flow node on both sides:
    an input of the reference's cond/while/scan equation, and of the
    port's ``higher_order`` node; the bodies hold no tensor constant; and
    the port's interpret mode gives the native values, which equal the
    reference's."""
    jfn, tfn, (x,), _ = PROGRAMS[name]
    jaxpr = jax.make_jaxpr(jfn)(jnp.asarray(x)).jaxpr
    y = next(e for e in jaxpr.eqns if e.primitive.name == "mul").outvars[0]
    flow = next(e for e in jaxpr.eqns
                if e.primitive.name in ("cond", "while", "scan"))
    assert _lifted_closures(flow.invars, y) == 1

    gm, _ = T.sentry.make_graph(tfn, (torch.from_numpy(x),))
    nodes = [n for n in gm.graph.nodes if n.op == "call_function"]
    y_node = next(n for n in nodes if n.target is torch.ops.aten.mul.Tensor)
    hop = next(n for n in nodes
               if isinstance(n.target, torch._ops.HigherOrderOperator))
    operands = [a for arg in hop.args if isinstance(arg, (tuple, list))
                for a in arg]
    assert _lifted_closures(operands, y_node) == 1
    assert not [n for n in gm.graph.nodes
                if n.op == "get_attr" and "_tensor_constant" in n.target]

    got = T.sandboxed(tfn, T.ModernEmulationPolicy(),
                      mode="interpret")(torch.from_numpy(x))
    want = tfn(torch.from_numpy(x))
    assert torch.equal(got, want)
    np.testing.assert_allclose(want.numpy(), np.asarray(jfn(jnp.asarray(x))),
                               rtol=1e-6)


def _costs(core, fn, args):
    meter = core.ResourceMeter()
    ticket = core.AdmissionController().admit(
        fn, args, policy=core.ModernEmulationPolicy(), meter=meter)
    return meter, dict(ticket.histogram)


def test_product_flops_match_reference_and_costs_are_logged():
    for name in ("scan_tanh", "erf", "matmul", "sort"):
        jfn, tfn, args, _ = PROGRAMS[name]
        jm, jh = _costs(J, jfn, tuple(jnp.asarray(a) for a in args))
        tm, th = _costs(T, tfn, tuple(torch.from_numpy(a) for a in args))
        print(f"{name}: reference flops {jm.flops} bytes {jm.bytes} eqns "
              f"{jm.eqn_count} {jh}; port flops {tm.flops} bytes {tm.bytes} "
              f"nodes {tm.eqn_count} {th}")
        assert tm.eqn_count > 0 and jm.eqn_count > 0
        if name == "matmul":
            assert tm.flops == jm.flops == 2 * 32 * 48 * 16


def _jax_scan_n(n):
    def f(x):
        return jax.lax.scan(lambda c, _: (jnp.tanh(c @ c), None), x, None,
                            length=n)[0]
    return f


def _torch_scan_n(n):
    def f(x):
        return torch_scan(lambda c, _: (torch.tanh(c @ c), c.sum()), x,
                          torch.zeros(n, 1))[0]
    return f


def test_scan_flops_scale_with_length_on_both_sides():
    for core, make, x in ((J, _jax_scan_n, jnp.ones((8, 8))),
                          (T, _torch_scan_n, torch.ones(8, 8))):
        m1, m2 = core.ResourceMeter(), core.ResourceMeter()
        core.sandboxed(make(4), core.ModernEmulationPolicy(), meter=m1)(x)
        core.sandboxed(make(8), core.ModernEmulationPolicy(), meter=m2)(x)
        assert abs(m2.flops / m1.flops - 2.0) < 0.2


# ------------------------------------------- both sides, same behaviour

SIDES = {
    "jax": (J, lambda a: jnp.asarray(a), _jax_scan,
            lambda x: jax.lax.erf(x).sum(), "erf"),
    "torch": (T, lambda a: torch.from_numpy(np.array(a)), _torch_scan,
              lambda x: torch.special.erf(x).sum(), "aten.erf"),
}


@pytest.fixture(params=list(SIDES))
def side(request):
    return SIDES[request.param]


def test_interpret_matches_verify(side):
    core, arr, scan_udf, _, _ = side
    x = arr(X16)
    pol = core.ModernEmulationPolicy()
    direct = core.sandboxed(scan_udf, pol, mode="verify")(x)
    interp = core.sandboxed(scan_udf, pol, mode="interpret")(x)
    np.testing.assert_allclose(np.asarray(direct), np.asarray(interp),
                               rtol=1e-6)


def test_interpret_matches_reference_values():
    # not X16: its tanh sums to ~0, where a relative bound means nothing
    x = np.linspace(-1.0, 2.0, 16, dtype=np.float32)
    ref = J.sandboxed(_jax_scan, J.ModernEmulationPolicy(),
                      mode="interpret")(jnp.asarray(x))
    got = T.sandboxed(_torch_scan, T.ModernEmulationPolicy(),
                      mode="interpret")(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def test_budget_enforced_and_precheck_uses_cached_totals(side):
    core, arr, _, _, _ = side
    ctl = core.AdmissionController()
    sb = core.Sandbox(policy=core.ModernEmulationPolicy(), flop_budget=100.0,
                      admission=ctl)
    big = (arr(np.ones((64, 64), np.float32)),) * 2
    for _ in range(2):         # the second is a warm admission, refused too
        with pytest.raises(core.BudgetExceeded):
            sb.run(_matmul, *big)
    assert ctl.stats()["hits"] == 1 and ctl.stats()["misses"] == 1


def test_cache_hit_miss_and_shape_keys(side):
    core, arr, _, _, _ = side
    ctl = core.AdmissionController()
    pol = core.ModernEmulationPolicy()
    args = (arr(np.ones((4, 4), np.float32)),) * 2
    t1 = ctl.admit(_matmul, args, policy=pol)
    t2 = ctl.admit(_matmul, args, policy=pol)
    assert not t1.cache_hit and t2.cache_hit
    assert t1.histogram == t2.histogram
    ctl.admit(_matmul, (arr(np.ones((2, 2), np.float32)),) * 2, policy=pol)
    assert ctl.stats()["misses"] == 2 and ctl.stats()["hits"] == 1


def test_kwarg_values_are_part_of_the_program(side):
    core, arr, _, _, _ = side
    ctl = core.AdmissionController()
    pol = core.ModernEmulationPolicy()
    fn = lambda x, scale=1.0: (x * scale).sum()   # noqa: E731
    x = (arr(np.ones(3, np.float32)),)
    t1 = ctl.admit(fn, x, {"scale": 2.0}, policy=pol)
    t2 = ctl.admit(fn, x, {"scale": 3.0}, policy=pol)
    t3 = ctl.admit(fn, x, {"scale": 2.0}, policy=pol)
    assert not t1.cache_hit and not t2.cache_hit and t3.cache_hit


def test_cache_keyed_on_policy_change(side):
    core, arr, _, erf_fn, erf_name = side
    ctl = core.AdmissionController()
    x = (arr(np.ones(4, np.float32)),)
    legacy = core.LegacyFilterPolicy()
    with pytest.raises(core.SandboxViolation):
        ctl.admit(erf_fn, x, policy=legacy)
    patched = legacy.extended(erf_name)    # same policy name, new surface
    assert not ctl.admit(erf_fn, x, policy=patched).cache_hit
    assert ctl.admit(erf_fn, x, policy=patched).cache_hit


def test_cache_invalidation(side):
    core, arr, _, _, _ = side
    ctl = core.AdmissionController()
    pol = core.ModernEmulationPolicy()
    fn = lambda x: x + 1                          # noqa: E731
    args = (arr(np.ones(3, np.float32)),)
    ctl.admit(fn, args, policy=pol)
    assert ctl.invalidate(pol) == 1 and ctl.stats()["entries"] == 0
    assert not ctl.admit(fn, args, policy=pol).cache_hit


def test_image_digest_pinning(side):
    core, arr, _, _, _ = side
    args = (arr(np.ones((2, 2), np.float32)),) * 2
    ok = core.AdmissionController(
        allowed_image_digests={core.DEFAULT_IMAGE.digest})
    ok.admit(_matmul, args, policy=core.ModernEmulationPolicy(),
             image=core.DEFAULT_IMAGE)
    pinned = core.AdmissionController(allowed_image_digests={"deadbeef"})
    with pytest.raises(core.ImageDigestError):
        pinned.admit(_matmul, args, policy=core.ModernEmulationPolicy(),
                     image=core.DEFAULT_IMAGE)


def test_closure_mutation_is_not_served_stale(side):
    core, arr, _, _, _ = side
    ctl = core.AdmissionController()
    sb = core.Sandbox(policy=core.ModernEmulationPolicy(), admission=ctl,
                      mode="interpret")
    c = [1.0]
    udf = lambda x: (x * c[0]).sum()              # noqa: E731
    x = arr(np.arange(4, dtype=np.float32))
    assert float(sb.run(udf, x).value) == 6.0
    c[0] = 2.0
    assert float(sb.run(udf, x).value) == 12.0
    assert ctl.stats()["misses"] == 2


def test_closures_over_two_large_tensors_get_two_entries(side):
    """Two 2048-element tensors that differ in one element: ``repr`` of a
    torch tensor that size is a summary, so a key from it would collide."""
    core, arr, _, _, _ = side
    ctl = core.AdmissionController()
    a = np.arange(2048, dtype=np.float32)
    b = a.copy()
    b[1024] = -1.0
    outs = []
    for w in (arr(a), arr(b)):
        udf = (lambda w: lambda x: (x * w).sum())(w)
        outs.append(float(core.Sandbox(
            policy=core.ModernEmulationPolicy(), admission=ctl,
            mode="interpret").run(udf, arr(np.ones(2048, np.float32))).value))
    assert ctl.stats()["entries"] == 2 and ctl.stats()["misses"] == 2
    assert outs == [float(a.sum()), float(b.sum())]


def test_sandbox_warm_admission_results_match(side):
    core, arr, _, _, _ = side
    sb = core.Sandbox(policy=core.ModernEmulationPolicy())
    a = arr(np.ones((8, 8), np.float32))
    cold = sb.run(_matmul, a, a)
    warm = sb.run(_matmul, a, a)
    assert not cold.cache_hit and warm.cache_hit
    assert cold.flops == warm.flops == 2 * 8 * 8 * 8
    np.testing.assert_array_equal(np.asarray(cold.value),
                                  np.asarray(warm.value))


# ------------------------------------------------------------- port only

def test_smuggled_callback_is_denied_in_interpret_mode():
    """The interpreter admits every node before it runs it: the custom op
    inside the ``cond`` branch is refused without the op ever running."""
    for mode in ("verify", "interpret"):
        with pytest.raises(T.SandboxViolation, match="seepp_control_plane"):
            T.sandboxed(_torch_smuggle, T.ModernEmulationPolicy(), mode=mode,
                        controller=T.AdmissionController())(torch.ones(3))


@pytest.mark.parametrize("udf", [
    lambda x: x * x.sum().item(),             # data-dependent scalar
    lambda x: torch.nonzero(x),               # data-dependent shape
])
def test_data_dependent_programs_fail_admission_as_user_errors(udf):
    """Fake tracing cannot follow a value read back to the host, as
    ``jax.make_jaxpr`` cannot: admission raises, and it is no denial."""
    ctl = T.AdmissionController()
    with pytest.raises(Exception) as info:
        ctl.admit(udf, (torch.ones(3),), policy=T.ModernEmulationPolicy())
    assert not isinstance(info.value, T.SandboxViolation)
    assert ctl.stats()["denials"] == 0


def test_interleaved_traces_on_two_threads_keep_their_own_nodes():
    """Thread A's program blocks inside its trace while thread B traces a
    whole program, then A resumes and finishes after B: each graph holds
    only its own operations (``make_fx`` fails this schedule, its
    process-wide patch state restored out of order)."""
    started, b_done = threading.Event(), threading.Event()
    graphs, errors = {}, []

    def prog_a(x):
        y = torch.sin(x)
        started.set()
        b_done.wait(timeout=30)
        return torch.cumsum(y, 0)

    def prog_b(x):
        return torch.flip(torch.cos(x), (0,))

    def run(name, fn):
        try:
            ticket = T.AdmissionController().admit(
                fn, (torch.ones(4),), policy=T.ModernEmulationPolicy())
            graphs[name] = dict(ticket.histogram)
        except BaseException as e:            # pragma: no cover - reported
            errors.append(e)
        if name == "b":
            b_done.set()

    ta = threading.Thread(target=run, args=("a", prog_a))
    ta.start()
    assert started.wait(timeout=30)
    tb = threading.Thread(target=run, args=("b", prog_b))
    tb.start()
    tb.join(timeout=60)
    ta.join(timeout=60)
    assert not errors, errors
    assert graphs == {"a": {"aten.sin": 1, "aten.cumsum": 1},
                      "b": {"aten.cos": 1, "aten.flip": 1}}


def test_policy_surface():
    """Any op outside aten/prims/higher_order is in the dangerous class;
    the legacy list has cond and while_loop as structural wrappers and
    not scan."""
    assert T.policy.is_dangerous("mylib.anything")
    assert T.policy.is_dangerous("aten._local_scalar_dense")
    assert not T.policy.is_dangerous("aten.mm")
    assert {"higher_order.cond", "higher_order.while_loop"} <= \
        T.LEGACY_ALLOWLIST
    assert "higher_order.scan" not in T.LEGACY_ALLOWLIST
    assert "aten.erf" not in T.LEGACY_ALLOWLIST
    for pol in (T.LegacyFilterPolicy().extended("mylib.anything"),
                T.ModernEmulationPolicy()):
        assert not pol.check("mylib.anything").admitted
