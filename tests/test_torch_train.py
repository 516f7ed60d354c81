"""The port's training path (``lm_loss``, the chunked CE, remat, the AdamW
train step) against the JAX package on shared weights.

Weights are drawn once by the JAX package's ``init_params`` and passed as
numpy through ``params_from_numpy``; ids and targets come from one numpy
generator. With ``use_flash_attention=True`` on both sides the JAX side
must really run its Pallas forward and backward (interpret mode): under
this suite's 8 host devices its ``flash_engages`` returns False, so the
tests patch it to True on the JAX module, and the port runs its flash
Function's plain forward and backward (CPU tensors).

Tolerances: f32 loss and grads atol 1e-5, rtol 1e-4 (summation order of
XLA vs PyTorch through eight matmuls and two backward passes); five
AdamW steps atol 1e-4 (Adam divides by sqrt(v), which lifts the grads'
rounding differences to the lr scale early on); bf16 loss within 1e-2
and grads relative L2 <= 2e-2 (bf16 rounds at the same points in both
packages, but products near a rounding boundary flip one ulp).
"""

from __future__ import annotations

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearning4j_tpu.zoo import transformer as jtfm
from deeplearning4j_tpu_torch.kernels import flash_attention as tfa
from deeplearning4j_tpu_torch.zoo import transformer as ttfm

torch.set_num_threads(2)


def _import_dynamo_beside_onnx_stub():
    """``torch.utils.checkpoint`` imports ``torch._dynamo`` on first use,
    and that import asks ``importlib.util.find_spec`` about optional
    packages such as ``onnx``. The ONNX import tests put a stub ``onnx``
    module without a spec into ``sys.modules`` when they are collected,
    which makes ``find_spec`` raise; import ``torch._dynamo`` here with
    the stub set aside, and put it back."""
    stub = sys.modules.pop("onnx", None)
    try:
        import torch._dynamo  # noqa: F401
    finally:
        if stub is not None:
            sys.modules["onnx"] = stub


_import_dynamo_beside_onnx_stub()

GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
TINY = dict(vocab_size=61, d_model=32, n_heads=2, n_layers=2, d_ff=64,
            max_seq=64, remat=False, attn_scores_bf16=False,
            use_flash_attention=True)


def configs(dtype="f32", **kw):
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    base = dict(TINY)
    base.update(kw)
    return (jtfm.TransformerConfig(dtype=jdt, **base),
            ttfm.TransformerConfig(dtype=tdt, **base))


@pytest.fixture
def jax_flash(monkeypatch):
    """Make the JAX side take its Pallas flash arm (see module doc)."""
    monkeypatch.setattr(jtfm, "flash_engages", lambda cfg, t: True)


@pytest.fixture(scope="module")
def shared_np():
    jcfg, _ = configs()
    jp = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    return jax.tree_util.tree_map(np.asarray, jp)


def _port_params(tree, tcfg):
    return ttfm.params_from_numpy(tree, tcfg, device="cpu")


def _batch(shape=(2, 24), seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, TINY["vocab_size"], shape).astype(np.int32)
    tgt = rng.integers(0, TINY["vocab_size"], shape).astype(np.int32)
    return ids, tgt


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _leaves_by_path(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves_by_path(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _port_loss_and_grads(tp, tcfg, ids, tgt):
    leaves = ttfm.param_leaves(tp)
    for p in leaves:
        p.grad = None
    loss = ttfm.lm_loss(tp, tcfg, _t(ids).long(), _t(tgt).long())
    loss.backward()
    grads = {k: v.grad for k, v in _leaves_by_path(tp).items()}
    return loss.detach(), grads


def test_chunked_ce_matches_jax_with_padding_and_weights():
    """N = 22 rows in chunks of 8 (two pad rows) with per-row weights
    and an output bias: the weighted NLL sum and its grads."""
    rng = np.random.default_rng(1)
    n, d, v = 22, 16, 37
    x = rng.standard_normal((n, d)).astype(np.float32)
    head = rng.standard_normal((d, v)).astype(np.float32) / 4
    tgt = rng.integers(0, v, n).astype(np.int32)
    w = rng.uniform(0, 2, n).astype(np.float32)
    bias = rng.standard_normal(v).astype(np.float32)

    def jloss(x, head, bias):
        return jtfm._chunked_ce(x, head, jnp.asarray(tgt), 8,
                                weights=jnp.asarray(w), bias=bias)

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(head), jnp.asarray(bias))
    xs = [_t(a).requires_grad_(True) for a in (x, head, bias)]
    tl = ttfm._chunked_ce(xs[0], xs[1], _t(tgt), 8, weights=_t(w),
                          bias=xs[2])
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    for a, b in zip(xs, jg):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b),
                                   **GRAD_TOL)
    # no weights: every row counts once; the pad rows still count none
    full = ttfm._chunked_ce(_t(x), _t(head), _t(tgt), 8)
    ref = torch.nn.functional.cross_entropy(_t(x) @ _t(head), _t(tgt).long(),
                                            reduction="sum")
    torch.testing.assert_close(full, ref, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("fused", [True, False])
def test_lm_loss_and_grads_match_jax_flash(shared_np, jax_flash, fused):
    """lm_loss (fused chunked CE with padding, or the naive full-logits
    loss) and its grad per leaf against jax.grad of the JAX package's,
    with flash attention on both sides: the port's flash Function
    against the JAX Pallas kernels' custom VJP."""
    jcfg, tcfg = configs(fused_loss=fused, loss_chunk=20)
    ids, tgt = _batch()
    jl, jg = jax.value_and_grad(jtfm.lm_loss)(
        jax.tree_util.tree_map(jnp.asarray, shared_np), jcfg,
        jnp.asarray(ids), jnp.asarray(tgt))
    tl, tg = _port_loss_and_grads(_port_params(shared_np, tcfg), tcfg, ids,
                                  tgt)
    np.testing.assert_allclose(tl.item(), float(jl), **GRAD_TOL)
    jgrads = _leaves_by_path(jax.tree_util.tree_map(np.asarray, jg))
    assert set(jgrads) == set(tg)
    for name, g in jgrads.items():
        np.testing.assert_allclose(tg[name].numpy(), g, err_msg=name,
                                   **GRAD_TOL)


def test_jax_side_really_runs_its_pallas_backward(shared_np, jax_flash,
                                                   monkeypatch):
    """The patched gate does route the JAX loss through its Pallas
    backward: count the calls of ``_flash_bwd_impl``."""
    import importlib
    jfa = importlib.import_module(
        "deeplearning4j_tpu.kernels.flash_attention")
    calls = []
    orig = jfa._flash_bwd_impl

    def counting(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(jfa, "_flash_bwd_impl", counting)
    jcfg, _ = configs()
    ids, tgt = _batch((1, 8))
    jax.grad(jtfm.lm_loss)(jax.tree_util.tree_map(jnp.asarray, shared_np),
                           jcfg, jnp.asarray(ids), jnp.asarray(tgt))
    assert calls                       # once per scanned block trace


def test_remat_policies_give_identical_loss_and_grads(shared_np):
    """Remat off, "full", "save_attn", "dots" and "dots_no_batch":
    recomputation changes what is saved, never a value."""
    ids, tgt = _batch(seed=2)
    runs = {}
    for policy in (None, "full", "save_attn", "dots", "dots_no_batch"):
        _, tcfg = configs(fused_loss=True, loss_chunk=16,
                          remat=policy is not None,
                          remat_policy=policy or "full")
        runs[policy] = _port_loss_and_grads(_port_params(shared_np, tcfg),
                                            tcfg, ids, tgt)
    loss0, grads0 = runs.pop(None)
    for policy, (loss, grads) in runs.items():
        assert torch.equal(loss, loss0), policy
        for name, g in grads.items():
            assert torch.equal(g, grads0[name]), (policy, name)


def test_remat_saves_less_than_no_remat(shared_np):
    """What autograd holds between forward and backward: "full" the
    least, "save_attn" the attention outputs on top, no remat the most."""
    ids, tgt = _batch(seed=3)
    held = {}
    for policy in (None, "full", "save_attn"):
        _, tcfg = configs(remat=policy is not None,
                          remat_policy=policy or "full")
        tp = _port_params(shared_np, tcfg)
        ttfm.param_leaves(tp)
        nbytes = []

        def pack(t):
            nbytes.append(t.numel() * t.element_size())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            ttfm.lm_loss(tp, tcfg, _t(ids).long(), _t(tgt).long())
        held[policy] = sum(nbytes)
    assert held["full"] < held["save_attn"] < held[None]


def test_unknown_remat_policy_raises(shared_np):
    _, tcfg = configs(remat=True, remat_policy="bogus")
    ids, tgt = _batch()
    tp = _port_params(shared_np, tcfg)
    with pytest.raises(ValueError, match="Unknown remat_policy 'bogus'"):
        ttfm.lm_loss(tp, tcfg, _t(ids).long(), _t(tgt).long())
    with torch.no_grad():              # no remat without grad: no check
        ttfm.lm_loss(tp, tcfg, _t(ids).long(), _t(tgt).long())


def test_train_steps_track_optax_adamw(shared_np, jax_flash):
    """Five steps of make_train_step with AdamW(lr=1e-3, wd=1e-4) against
    the JAX package's make_train_step with optax.adamw(1e-3) on one
    batch: every step's loss and the final params."""
    jcfg, tcfg = configs(fused_loss=True, loss_chunk=20, remat=True,
                         remat_policy="save_attn")
    jp = jax.tree_util.tree_map(jnp.asarray, shared_np)
    opt = optax.adamw(1e-3)
    jstate = opt.init(jp)
    jstep = jtfm.make_train_step(jcfg, opt)
    tp = _port_params(shared_np, tcfg)
    topt = torch.optim.AdamW(ttfm.param_leaves(tp), lr=1e-3,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)
    tstep = ttfm.make_train_step(tcfg, topt)
    losses = []
    ids, tgt = _batch(seed=10)
    for _ in range(5):
        jp, jstate, jl = jstep(jp, jstate, jnp.asarray(ids),
                               jnp.asarray(tgt))
        tl = tstep(tp, ids, tgt)            # numpy in, as a caller has
        assert tl.shape == () and not tl.requires_grad
        np.testing.assert_allclose(tl.item(), float(jl), atol=1e-4)
        losses.append(tl.item())
    assert losses[-1] < losses[0]
    ref = _leaves_by_path(jax.tree_util.tree_map(np.asarray, jp))
    for name, p in _leaves_by_path(tp).items():
        np.testing.assert_allclose(p.detach().numpy(), ref[name], atol=1e-4,
                                   err_msg=name)


def test_bf16_loss_and_grads_match_jax(shared_np, jax_flash):
    """The bf16 model (flash on both sides, fused loss): loss within
    1e-2 and every leaf's grad within relative L2 2e-2."""
    jcfg, tcfg = configs("bf16", fused_loss=True, loss_chunk=20)
    ids, tgt = _batch(seed=4)
    jl, jg = jax.value_and_grad(jtfm.lm_loss)(
        jax.tree_util.tree_map(jnp.asarray, shared_np), jcfg,
        jnp.asarray(ids), jnp.asarray(tgt))
    tl, tg = _port_loss_and_grads(_port_params(shared_np, tcfg), tcfg, ids,
                                  tgt)
    assert abs(tl.item() - float(jl)) <= 1e-2
    for name, g in _leaves_by_path(
            jax.tree_util.tree_map(np.asarray, jg)).items():
        got = tg[name].double().numpy()
        rel = np.linalg.norm(got - g) / np.linalg.norm(g)
        assert rel <= 2e-2, (name, rel)


def test_forward_is_no_grad_unless_train(shared_np):
    _, tcfg = configs()
    tp = _port_params(shared_np, tcfg)
    ttfm.param_leaves(tp)
    ids = _t(_batch()[0]).long()
    logits, _ = ttfm.forward(tp, tcfg, ids)
    assert not logits.requires_grad
    logits, _ = ttfm.forward(tp, tcfg, ids, train=True)
    assert logits.requires_grad
    with torch.no_grad():
        logits, _ = ttfm.forward(tp, tcfg, ids, train=True)
    assert not logits.requires_grad


def test_fused_loss_auto_gate():
    _, tcfg = configs(vocab_size=32000, fused_loss="auto")
    assert not ttfm._use_fused_loss(tcfg, 512)       # 62.5 MiB of logits
    assert ttfm._use_fused_loss(tcfg, 1024)           # 125 MiB
    assert ttfm._use_fused_loss(dataclasses.replace(tcfg, fused_loss=True),
                                1)
    assert not ttfm._use_fused_loss(
        dataclasses.replace(tcfg, fused_loss=False), 10 ** 6)
    for n in (512, 1024, 4096):
        assert ttfm._use_fused_loss(tcfg, n) == jtfm._use_fused_loss(
            jtfm.TransformerConfig(vocab_size=32000), n)


def test_param_leaves_require_grad_in_key_order(shared_np):
    _, tcfg = configs()
    tp = _port_params(shared_np, tcfg)
    leaves = ttfm.param_leaves(tp)
    assert all(p.requires_grad and p.is_leaf for p in leaves)
    assert [id(p) for p in leaves] == [
        id(p) for p in _leaves_by_path(tp).values()]


def test_train_step_counts_no_cuda_launch_on_cpu(shared_np):
    """On CPU tensors the flash Function runs its plain versions: a
    train step with flash engaged launches no kernel."""
    _, tcfg = configs(fused_loss=True, remat=True, remat_policy="save_attn")
    tp = _port_params(shared_np, tcfg)
    opt = torch.optim.AdamW(ttfm.param_leaves(tp), lr=1e-3,
                            weight_decay=1e-4)
    tfa.reset_launches()
    loss = ttfm.make_train_step(tcfg, opt)(tp, *_batch())
    assert torch.isfinite(loss)
    assert (tfa.LAUNCHES, tfa.LAUNCHES_BWD_DQ, tfa.LAUNCHES_BWD_DKV) == \
        (0, 0, 0)


def _head_dim_lm_parity(monkeypatch, head_dim, **cfg):
    """A Transformer-LM (2 heads, 2 layers, flash attention on both sides,
    T 64) of the given head dim: its forward logits and its step-1 grads
    through the port's plain path against the JAX package's Pallas
    kernels (interpret mode), whose forward and backward calls are
    counted to show that they ran. f32 values atol 1e-5, grads atol
    1e-4."""
    import importlib
    jfa = importlib.import_module(
        "deeplearning4j_tpu.kernels.flash_attention")
    calls = {"fwd": 0, "bwd": 0}
    orig_fwd, orig_bwd = jfa._fwd, jfa._flash_bwd_impl

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(jfa, "_fwd", count("fwd", orig_fwd))
    monkeypatch.setattr(jfa, "_flash_bwd_impl", count("bwd", orig_bwd))
    jcfg, tcfg = configs(**cfg)
    assert tcfg.head_dim == head_dim
    jp = jtfm.init_params(jax.random.PRNGKey(3), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tp = _port_params(tree, tcfg)
    ids, tgt = _batch((2, 64), seed=7)
    jl, _ = jtfm.forward(jp, jcfg, jnp.asarray(ids))
    tl, _ = ttfm.forward(tp, tcfg, _t(ids).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=1e-5)
    jloss, jg = jax.value_and_grad(jtfm.lm_loss)(
        jp, jcfg, jnp.asarray(ids), jnp.asarray(tgt))
    tloss, tg = _port_loss_and_grads(tp, tcfg, ids, tgt)
    assert calls["fwd"] and calls["bwd"]
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=1e-5)
    jgrads = _leaves_by_path(jax.tree_util.tree_map(np.asarray, jg))
    assert set(jgrads) == set(tg)
    for name, g in jgrads.items():
        np.testing.assert_allclose(tg[name].numpy(), g, err_msg=name,
                                   atol=1e-4, rtol=1e-4)


def test_head_dim_80_lm_matches_jax_flash(jax_flash, monkeypatch):
    """Head dim 80 (d_model 160), the shape the card's kernels take by
    zero-padding to 128 inside the kernel (see _head_dim_lm_parity)."""
    _head_dim_lm_parity(monkeypatch, 80, d_model=160, d_ff=128)


@pytest.mark.parametrize("head_dim", [160, 200, 256])
def test_wide_head_dim_lm_matches_jax_flash(jax_flash, monkeypatch,
                                            head_dim):
    """Head dims 160, 200 and 256 (d_model 320, 400 and 512), which the
    card runs with K1, dQ and dK/dV padded to 256 on the tensor cores: in
    bf16 as bf16 products (dQ and dK/dV on two warpgroups), in f32 as
    split-TF32 products (see _head_dim_lm_parity)."""
    _head_dim_lm_parity(monkeypatch, head_dim, d_model=2 * head_dim,
                        d_ff=128)
