"""utils/flops.py and utils/profiling.py::trace of the port against ocl_tpu's.

* tests/test_flops.py's cases (dense, conv, grad, scan, jit) count the same
  FLOPs in the port (a Python loop stands for the scan, torch.jit.script
  for jit).
* A fused-ER step with a full buffer at nf 4: the convolution and matmul
  FLOPs equal ocl_tpu's exactly once each lhs-dilated convolution of its
  jaxpr (a strided convolution's input gradient) is divided by its
  dilation; the whole count is within 5% of ocl_tpu's, less that over-count.
* The over-count: ocl_tpu charges a stride-s convolution's input gradient
  s² times its forward's work, the port once; and counting leaves the
  counted state as it was.
* trace() writes a Chrome trace that kernel_timing.trace_events parses,
  naming a step's convolutions.
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ocl_tpu.config import default_params as j_default_params
from ocl_tpu.registry import agents as j_agents
from ocl_tpu.utils import flops as j_flops
from ocl_tpu_torch.config import default_params
from ocl_tpu_torch.registry import agents
from ocl_tpu_torch.tools.kernel_timing import trace_events
from ocl_tpu_torch.utils.flops import FlopCount, estimate_fn_flops
from ocl_tpu_torch.utils.profiling import TRACE_FILE, trace

ER = dict(data="synthetic", agent="ER", mem_size=100, batch=10, eps_mem_batch=10, nf=4,
          verbose=False)


def test_dense_flops_match_ocl_tpu():
    want = j_flops.estimate_fn_flops(lambda x, w: x @ w, jnp.zeros((8, 64)), jnp.zeros((64, 32)))
    got = estimate_fn_flops(lambda x, w: x @ w, torch.zeros(8, 64), torch.zeros(64, 32))
    assert got == want == 2 * 8 * 64 * 32


def test_conv_flops_match_ocl_tpu():
    def j_conv(x, k):
        return jax.lax.conv_general_dilated(x, k, (1, 1), "SAME",
                                            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    want = j_flops.estimate_fn_flops(j_conv, jnp.zeros((4, 16, 16, 3)), jnp.zeros((3, 3, 3, 8)))
    got = estimate_fn_flops(lambda x, k: F.conv2d(x, k, padding=1), torch.zeros(4, 3, 16, 16),
                            torch.zeros(8, 3, 3, 3))
    assert got == want == 2 * (4 * 16 * 16 * 8) * (3 * 3 * 3)


def test_grad_flops_match_ocl_tpu():
    x = np.zeros((8, 32), np.float32)

    def j_loss(w):
        return jnp.sum((x @ w) ** 2)

    def loss(w):
        return ((torch.from_numpy(x) @ w) ** 2).sum()

    w = torch.zeros(32, 32, requires_grad=True)
    fwd = estimate_fn_flops(loss, w)
    bwd = estimate_fn_flops(lambda w: torch.autograd.grad(loss(w), w), w)
    assert fwd == j_flops.estimate_fn_flops(j_loss, jnp.zeros((32, 32)))
    assert bwd == j_flops.estimate_fn_flops(jax.grad(j_loss), jnp.zeros((32, 32)))
    assert bwd >= 2 * fwd  # fwd + at least one matmul-sized transpose pass


def test_loop_counts_each_iteration_as_scan_does():
    def j_fn(w, xs):
        return jax.lax.scan(lambda c, x: (c, x @ w), None, xs)[1]

    want = j_flops.estimate_fn_flops(j_fn, jnp.zeros((16, 16)), jnp.zeros((10, 4, 16)))
    got = estimate_fn_flops(lambda w, xs: [x @ w for x in xs], torch.zeros(16, 16),
                            torch.zeros(10, 4, 16))
    assert got == want == 10 * 2 * 4 * 16 * 16


def _mm(x, w):
    return x @ w


def test_counts_through_torch_jit():
    want = j_flops.estimate_fn_flops(jax.jit(lambda x, w: x @ w), jnp.zeros((4, 16)),
                                     jnp.zeros((16, 16)))
    got = estimate_fn_flops(torch.jit.script(_mm), torch.zeros(4, 16), torch.zeros(16, 16))
    assert got == want == 2 * 4 * 16 * 16


def jaxpr_matmul_flops(jaxpr):
    """(dot + conv FLOPs as ocl_tpu counts them, the same with each
    lhs-dilated convolution divided by its dilation), walking scan, cond
    (the costlier branch, ocl_tpu's cond_mode "max"), while and call
    primitives as utils/flops.py::count_jaxpr_flops does."""
    counted = corrected = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "dot_general":
            f = j_flops._dot_flops(eqn)
            counted, corrected = counted + f, corrected + f
        elif name == "conv_general_dilated":
            f = j_flops._conv_flops(eqn)
            counted += f
            corrected += f // math.prod(eqn.params["lhs_dilation"])
        elif name == "scan":
            c, k = jaxpr_matmul_flops(eqn.params["jaxpr"].jaxpr)
            counted, corrected = counted + eqn.params["length"] * c, \
                corrected + eqn.params["length"] * k
        elif name == "cond":
            c, k = max(jaxpr_matmul_flops(b.jaxpr) for b in eqn.params["branches"])
            counted, corrected = counted + c, corrected + k
        elif name == "while":
            c, k = jaxpr_matmul_flops(eqn.params["body_jaxpr"].jaxpr)
            counted, corrected = counted + c, corrected + k
        else:
            inner = eqn.params.get("jaxpr") or eqn.params.get("call_jaxpr") \
                or eqn.params.get("fun_jaxpr")
            if inner is not None:
                c, k = jaxpr_matmul_flops(inner.jaxpr if hasattr(inner, "jaxpr") else inner)
                counted, corrected = counted + c, corrected + k
    return counted, corrected


@pytest.fixture(scope="module")
def er_counts():
    """ocl_tpu's fused-ER step (one step of its task scan): (total,
    matmul as counted, matmul corrected)."""
    agent = j_agents["ER"](j_default_params(**ER))
    state = agent.init_state(jax.random.PRNGKey(0))
    ctx = agent.before_train(list(range(10)))
    jaxpr = jax.make_jaxpr(agent._build_train_task_fn())(
        state, ctx, jnp.zeros((1, 10, 32, 32, 3)), jnp.zeros((1, 10), jnp.int32))
    return (j_flops.count_jaxpr_flops(jaxpr.jaxpr),) + jaxpr_matmul_flops(jaxpr.jaxpr)


def full_buffer_state():
    """The port's fused ER at nf 4 after 11 steps of class images, its
    buffer of 100 full; and the next batch."""
    agent = agents["ER"](default_params(**ER, device="cpu"))
    state = agent.init_state(0)
    g = np.random.RandomState(0)
    x = torch.from_numpy(g.rand(120, 32, 32, 3).astype(np.float32))
    y = torch.from_numpy(g.randint(0, 10, 120))
    ctx = agent.before_train(y)
    agent.train_task(state, ctx, x[:110], y[:110])
    assert state.buffer.current_index == 100
    return agent, state, ctx, x[110:], y[110:]


def test_er_step_flops_match_ocl_tpu(er_counts):
    j_total, j_matmul, j_matmul_corrected = er_counts
    agent, state, ctx, xb, yb = full_buffer_state()
    with FlopCount() as counter:
        agent.step(copy.deepcopy(state), ctx, xb, yb)
    over_count = j_matmul - j_matmul_corrected
    print("ocl_tpu: {} FLOPs, {} of them convolutions and matmuls, {} of those the "
          "lhs-dilated over-count; port: {} ({} convolutions and matmuls)".format(
              j_total, j_matmul, over_count, counter.total, counter.matmul))
    assert over_count > 0
    assert counter.matmul == j_matmul_corrected
    assert counter.total == pytest.approx(j_total - over_count, rel=0.05)


def test_counting_leaves_the_state_as_it_was():
    agent, state, ctx, xb, yb = full_buffer_state()
    before = copy.deepcopy(state)
    grads = [None if p.grad is None else p.grad.clone() for p in state.model.parameters()]
    flops = estimate_fn_flops(agent.step, state, ctx, xb, yb)
    assert flops > 0
    for (name, a), b in zip(state.model.state_dict().items(), before.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert torch.equal(state.buffer.imgs, before.buffer.imgs)
    assert torch.equal(state.buffer.labels, before.buffer.labels)
    assert torch.equal(state.generator.get_state(), before.generator.get_state())
    for p, g in zip(state.model.parameters(), grads):
        assert (p.grad is None and g is None) or torch.equal(p.grad, g)


def test_strided_input_gradient_is_charged_its_forward():
    """Input [4, 16, 16, 8], a 3x3 kernel from 8 to 16 channels at stride 2:
    ocl_tpu charges the input gradient (an lhs-dilated convolution) 4 = 2²
    times the forward's work; the port charges it once, as
    torch.utils.flop_counter does, and both agree at stride 1."""
    for stride in (1, 2):
        def j_grads(x, k, stride=stride):
            def f(x, k):
                return jnp.sum(jax.lax.conv_general_dilated(
                    x, k, (stride, stride), [(1, 1), (1, 1)],
                    dimension_numbers=("NHWC", "HWIO", "NHWC")))
            return jax.grad(f, argnums=(0, 1))(x, k)

        def grads(x, k, stride=stride):
            return torch.autograd.grad(F.conv2d(x, k, stride=stride, padding=1).sum(), (x, k))

        jaxpr = jax.make_jaxpr(j_grads)(jnp.zeros((4, 16, 16, 8)), jnp.zeros((3, 3, 8, 16)))
        j_counted, j_corrected = jaxpr_matmul_flops(jaxpr.jaxpr)
        x = torch.zeros(4, 8, 16, 16, requires_grad=True)
        k = torch.zeros(16, 8, 3, 3, requires_grad=True)
        with FlopCount() as counter:
            grads(x, k)
        out = 16 // stride
        forward = 2 * (4 * out * out * 16) * (3 * 3 * 8)
        assert counter.matmul == j_corrected == 3 * forward   # forward, input and weight grads
        assert j_counted == (2 + stride ** 2) * forward
    assert j_counted == 3_538_944 and counter.matmul == 1_769_472


def test_trace_writes_a_chrome_trace_naming_the_convolutions(tmp_path):
    agent, state, ctx, xb, yb = full_buffer_state()
    with trace(str(tmp_path / "trace")) as prof:
        agent.step(state, ctx, xb, yb)
    events = trace_events(str(tmp_path / "trace" / TRACE_FILE))
    ops = {name for name, cat, _, dur in events if cat == "cpu_op" and dur >= 0}
    assert {"aten::convolution", "aten::convolution_backward"} <= ops
    assert prof.profiler is not None
