"""The port's training slice (paddle_tpu_torch: GPT, AdamW, TrainStepper)
against the JAX package's, on the same numpy-made weights and batches.

- A tiny GPT (E=64, H=4, 2 layers, V=256, 256 positions) on both sides
  from one set of numpy weights, loaded into the port through
  ``gpt_params_from_jax``; three fp32 ``TrainStepper`` steps with AdamW.
  At S=256 the port's attention takes the flash route (the kernels' plain
  versions on the CPU), at S=128 the plain composition; the JAX package
  on the CPU takes its XLA composition at both, the same math. Per-step
  losses agree within 1e-5 relative, the parameters after three steps
  within 2e-4 everywhere and 1e-6 for 99.9% of entries (fp32 sums in
  different orders, which Adam amplifies where a gradient is near zero).
- Under ``amp_level="O2"`` (bf16 compute, fp32 masters): bf16-valued
  losses within one bf16 ulp of the reference's, first-step gradients
  within 2e-2 in relative norm of its O2 ones and at least 1e-3 from its
  fp32 ones; the port without AMP misses these limits.
- At V=2048 the loss takes the fused softmax cross-entropy route: the
  same fp32 limits.
- AdamW and Adam alone against ``apply_gradients_functional``, moments in
  fp32 and bf16.
- The attention routing predicate against the reference's shape gate;
  entry points raise without a card unless given ``device="cpu"``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional.attention as jax_attention
from paddle_tpu import optimizer as jax_optimizer
from paddle_tpu.core.tensor import Parameter as JaxParameter
from paddle_tpu.jit import TrainStepper as JaxTrainStepper
from paddle_tpu.text.models import GPTConfig as JaxGPTConfig
from paddle_tpu.text.models import GPTForCausalLM as JaxGPT
from paddle_tpu_torch import amp, optimizer
from paddle_tpu_torch.jit import TrainStepper
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.text.models import (GPTConfig, GPTForCausalLM,
                                          gpt_params_from_jax)

pytestmark = pytest.mark.torch_port

CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=256, dropout=0.0)
LR = 1e-3


def numpy_weights(seed=0, cfg=CFG):
    """Weights for every parameter of the JAX model, by name: matrices
    N(0, 0.1), LayerNorm scales near 1, biases small and non-zero."""
    paddle.seed(0)
    names = [(n, tuple(p.shape)) for n, p in
             JaxGPT(JaxGPTConfig(**cfg)).named_parameters()]
    rs = np.random.RandomState(seed)
    out = {}
    for name, shape in names:
        if name.endswith("ln1.weight") or name.endswith("ln2.weight") \
                or name.endswith("ln_f.weight"):
            w = 1.0 + 0.1 * rs.randn(*shape)
        elif len(shape) == 1:
            w = 0.02 * rs.randn(*shape)
        else:
            w = 0.1 * rs.randn(*shape)
        out[name] = w.astype(np.float32)
    return out


def jax_model(weights, cfg=CFG):
    model = JaxGPT(JaxGPTConfig(**cfg))
    for name, p in model.named_parameters():
        p.set_value(weights[name])
    return model


def port_model(weights, cfg=CFG):
    model = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    model.load_state_dict(gpt_params_from_jax(weights, device="cpu"))
    return model


def assert_params_close(got_params, want_params, weights):
    """Parameters after the steps: all within 2e-4 and 99.9% of each
    tensor's entries within 1e-6. Adam divides each gradient by its own
    running size, so an entry whose gradient is near zero turns fp32
    summation noise into a different step of up to ``lr``; a few entries
    do (the largest seen: 1.2e-4). The k third of each ``qkv.bias`` has a
    gradient of exactly zero in exact arithmetic (a bias on every key
    shifts a query's scores by one constant, which the softmax ignores),
    so both sides hold only noise there: those entries are held to having
    moved at most ``lr`` per step from the start, on both sides."""
    e = CFG["hidden_size"]
    assert set(got_params) == set(want_params)
    for name, want in want_params.items():
        got = got_params[name]
        if name.endswith("qkv.bias"):
            start = weights[name][e:2 * e]
            for side in (got, want):
                assert np.abs(side[e:2 * e] - start).max() <= 3 * LR * 1.01
            got = np.concatenate([got[:e], got[2 * e:]])
            want = np.concatenate([want[:e], want[2 * e:]])
        diff = np.abs(got - want)
        assert diff.max() <= 2e-4, (name, diff.max())
        assert np.quantile(diff, 0.999) <= 1e-6, (name, diff)


def port_grads(weights, ids, amp_level):
    """The gradients of one forward + loss + backward of the port, as
    ``TrainStepper.step`` computes them before its update."""
    model = port_model(weights)
    x = torch.from_numpy(ids)
    with amp.auto_cast(amp_level):
        out = model(x)
    model.loss(out, x).float().backward()
    return {n: p.grad.numpy() for n, p in model.named_parameters()}


def jax_grads(weights, ids, amp_level):
    """The reference's gradients, read off one SGD step of lr 1 of its
    ``TrainStepper`` (``p - 1 * g``)."""
    model = jax_model(weights)
    opt = jax_optimizer.SGD(1.0, parameters=model.parameters())
    stepper = JaxTrainStepper(model, lambda out, lab: model.loss(out,
                                                                 lab[0]),
                              opt, amp_level=amp_level)
    x = (paddle.to_tensor(ids),)
    stepper.step(x, x)
    return {n: weights[n] - np.asarray(p.numpy())
            for n, p in model.named_parameters()}


def run_jax(weights, ids, amp_level, n_steps=3, cfg=CFG):
    model = jax_model(weights, cfg)
    opt = jax_optimizer.AdamW(LR, parameters=model.parameters())
    stepper = JaxTrainStepper(model, lambda out, lab: model.loss(out,
                                                                 lab[0]),
                              opt, amp_level=amp_level)
    x = (paddle.to_tensor(ids),)
    losses = [float(np.asarray(stepper.step(x, x)[0].numpy()))
              for _ in range(n_steps)]
    params = {n: np.asarray(p.numpy()) for n, p in model.named_parameters()}
    return losses, params


def run_port(weights, ids, amp_level, n_steps=3, cfg=CFG):
    model = port_model(weights, cfg)
    opt = optimizer.AdamW(LR, parameters=model.parameters())
    stepper = TrainStepper(model, lambda out, lab: model.loss(out, lab[0]),
                           opt, amp_level=amp_level)
    x = (torch.from_numpy(ids),)
    losses = [stepper.step(x, x)[0].item() for _ in range(n_steps)]
    params = {n: p.detach().numpy() for n, p in model.named_parameters()}
    return losses, params


@pytest.fixture(scope="module")
def weights():
    return numpy_weights()


@pytest.mark.parametrize("seq", [256, 128])
def test_fp32_train_steps_match_jax(weights, seq):
    ids = np.random.RandomState(seq).randint(0, CFG["vocab_size"],
                                             (2, seq)).astype(np.int64)
    want_losses, want_params = run_jax(weights, ids, None)
    _build.reset_launches()
    got_losses, got_params = run_port(weights, ids, None)
    assert _build.launches() == {}  # CPU: the kernels' plain versions
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5, atol=0)
    assert got_losses[-1] < got_losses[0]
    assert_params_close(got_params, want_params, weights)


def test_fp32_train_steps_on_the_fused_xent_route_match_jax(monkeypatch):
    """At V=2048 the loss takes the fused softmax cross-entropy route (the
    kernels' plain versions on the CPU) and attention the flash route;
    the JAX package on the CPU takes its plain compositions. Same limits
    as the V=256 steps."""
    import paddle_tpu_torch.nn.functional.loss as port_loss

    cfg = dict(CFG, vocab_size=2048)
    weights = numpy_weights(cfg=cfg)
    ids = np.random.RandomState(9).randint(0, 2048,
                                           (2, 256)).astype(np.int64)
    want_losses, want_params = run_jax(weights, ids, None, cfg=cfg)
    calls = []
    real = port_loss.fused_softmax_cross_entropy

    def spy(*args):
        calls.append(tuple(args[0].shape))
        return real(*args)

    monkeypatch.setattr(port_loss, "fused_softmax_cross_entropy", spy)
    got_losses, got_params = run_port(weights, ids, None, cfg=cfg)
    assert calls == [(512, 2048)] * 3
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5, atol=0)
    assert_params_close(got_params, want_params, weights)


def test_flash_route_taken_at_256_and_not_at_128(monkeypatch, weights):
    import paddle_tpu_torch.nn.functional.attention as port_attention

    calls = []
    real = port_attention.flash_attention

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(port_attention, "flash_attention", spy)
    model = port_model(weights)
    for seq in (256, 128):
        calls.clear()
        model(torch.zeros(1, seq, dtype=torch.long))
        assert len(calls) == (CFG["num_layers"] if seq == 256 else 0)


def o2_failures(losses, grads, jax_losses, jax_o2_grads, jax_fp32_grads):
    """The limits an O2 run of the port is held to against the reference's
    O2 run; returns the ones it misses (none when O2 is applied as the
    reference applies it).

    - Each step's loss is a bf16 value (the loss comes from bf16 logits)
      and within one bf16 ulp (2**-7 relative) of the reference's.
    - Each first-step gradient is within 2e-2 in relative norm of the
      reference's O2 gradient (bf16 activations rounded at different
      places), and at least 1e-3 away from its fp32 gradient.

    Readings (tiny GPT, S=256): the port at O2 gives the reference's
    three losses exactly and gradients 2.0e-3..1.01e-2 from its O2 ones
    and 4.7e-3..9.9e-3 from its fp32 ones. The port run in fp32 (no AMP)
    instead gives losses 1.1e-4..2.1e-3 off and not bf16 values, and
    gradients 5.1e-3..1.03e-2 from the O2 ones but within 6.2e-6 of the
    fp32 ones, so it misses the loss and the distance-from-fp32 limits.
    ``-s`` prints the readings."""
    e = CFG["hidden_size"]
    fails, to_o2, to_fp32 = [], {}, {}
    losses = np.asarray(losses, np.float32)
    if not np.array_equal(
            torch.from_numpy(losses).bfloat16().float().numpy(), losses):
        fails.append(f"losses {losses} are not bf16 values")
    rel = np.abs(losses - jax_losses) / np.abs(jax_losses)
    if (rel > 2 ** -7).any():
        fails.append(f"losses {rel} relative from the reference's")
    for name, g in grads.items():
        a, b, c = g, jax_o2_grads[name], jax_fp32_grads[name]
        if name.endswith("qkv.bias"):  # k third: zero gradient, see above
            a, b, c = (np.delete(x, np.s_[e:2 * e]) for x in (a, b, c))
        to_o2[name] = np.linalg.norm(a - b) / np.linalg.norm(b)
        to_fp32[name] = np.linalg.norm(a - c) / np.linalg.norm(c)
        if to_o2[name] > 2e-2:
            fails.append(f"{name}: {to_o2[name]} from the O2 gradient")
        if to_fp32[name] < 1e-3:
            fails.append(f"{name}: {to_fp32[name]} from the fp32 gradient")
    print(f"losses {rel} relative from the reference's O2 ones; gradients "
          f"{min(to_o2.values()):.2e}..{max(to_o2.values()):.2e} from its "
          f"O2 ones, {min(to_fp32.values()):.2e}..{max(to_fp32.values()):.2e}"
          f" from its fp32 ones")
    return fails


def test_o2_train_steps_match_jax(weights):
    """O2 against the reference's O2: three AdamW steps and the first
    step's gradients, held to :func:`o2_failures`; parameters stay fp32
    masters. The parameters after Adam steps are not compared: with bf16
    gradients many entries are near enough to zero for Adam to step them
    differently. The control, the port without AMP, must miss the
    limits."""
    ids = np.random.RandomState(7).randint(0, CFG["vocab_size"],
                                           (2, 256)).astype(np.int64)
    want_losses, _ = run_jax(weights, ids, "O2")
    want_o2 = jax_grads(weights, ids, "O2")
    want_fp32 = jax_grads(weights, ids, None)
    got_losses, got_params = run_port(weights, ids, "O2")
    assert got_losses[-1] < got_losses[0]
    assert all(p.dtype == np.float32 for p in got_params.values())
    assert o2_failures(got_losses, port_grads(weights, ids, "O2"),
                       want_losses, want_o2, want_fp32) == []
    control_losses, _ = run_port(weights, ids, None)
    assert o2_failures(control_losses, port_grads(weights, ids, None),
                       want_losses, want_o2, want_fp32) != []


def test_o2_cast_rule(weights):
    """Under O2 an fp32 input of a non-black-list op is cast to bf16, a
    bf16 input of a black-list op to fp32; outside, nothing changes. O1
    is not ported: the cast rule and the stepper refuse it."""
    x32 = torch.ones(2, 3)
    x16 = x32.bfloat16()
    with amp.auto_cast("O2"):
        assert F.linear(x32, torch.ones(3, 4)).dtype == torch.bfloat16
        assert F.add(x32, x32).dtype == torch.bfloat16
        assert F.layer_norm(x16, torch.ones(3), torch.zeros(3)).dtype \
            == torch.float32
        assert F.gelu(x32).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="O2"):
        with amp.auto_cast("O1"):
            pass
    model = port_model(weights)
    with pytest.raises(NotImplementedError, match="O1"):
        TrainStepper(model, model.loss,
                     optimizer.AdamW(LR, parameters=model.parameters()),
                     amp_level="O1")
    assert F.linear(x32, torch.ones(3, 4)).dtype == torch.float32


@pytest.mark.parametrize("opt_name", ["AdamW", "Adam"])
@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"])
def test_optimizer_matches_apply_gradients_functional(opt_name,
                                                      moment_dtype):
    rs = np.random.RandomState(3)
    shapes = [(5, 7), (7,), (3, 2, 4)]
    params = [rs.randn(*s).astype(np.float32) for s in shapes]
    kwargs = dict(moment_dtype=moment_dtype)
    if opt_name == "Adam":
        kwargs["weight_decay"] = 0.05  # coupled L2 in Adam
    jax_params = [JaxParameter(p.copy()) for p in params]
    jax_opt = getattr(jax_optimizer, opt_name)(0.01, parameters=jax_params,
                                               **kwargs)
    state = jax_opt.init_state_tree(jax_params)
    want = [p._data for p in jax_params]
    port_params = [torch.nn.Parameter(torch.from_numpy(p.copy()))
                   for p in params]
    port_opt = getattr(optimizer, opt_name)(0.01, parameters=port_params,
                                            **kwargs)
    for _ in range(3):
        grads = [rs.randn(*s).astype(np.float32) for s in shapes]
        want, state = jax_opt.apply_gradients_functional(want, grads, state)
        for p, g in zip(port_params, grads):
            p.grad = torch.from_numpy(g)
        port_opt.step()
    for p, w in zip(port_params, want):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                   rtol=0, atol=2e-6)
    for p, accs in zip(port_params, state["accums"]):
        for got, ref in zip(port_opt._state[id(p)], accs):
            assert got.dtype == (torch.bfloat16 if moment_dtype
                                 else torch.float32)
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(ref, np.float32),
                                       rtol=1e-2 if moment_dtype else 1e-6,
                                       atol=1e-6)


def test_adamw_apply_decay_param_fun():
    p = torch.nn.Parameter(torch.ones(2))
    q = torch.nn.Parameter(torch.ones(2))
    opt = optimizer.AdamW(0.1, parameters=[p, q], weight_decay=0.5,
                          apply_decay_param_fun=lambda n: n == "p")
    opt.set_param_names([("p", p), ("q", q)])
    p.grad = torch.zeros(2)
    q.grad = torch.zeros(2)
    opt.step()
    torch.testing.assert_close(p.detach(), torch.full((2,), 0.95))
    torch.testing.assert_close(q.detach(), torch.ones(2))


def test_routing_predicate_is_the_reference_shape_gate():
    """``would_use_flash`` is the reference's ``would_use_pallas`` without
    its backend test (no mask, ``seq_q >= 256``, the flash shape gate):
    the device, not the predicate, picks kernel or plain version. On the
    CPU the reference's own predicate is False for every shape."""
    from paddle_tpu.ops.pallas.flash_attention import supports as gate

    for sq, sk, d in [(256, 256, 64), (128, 128, 64), (1024, 1024, 128),
                      (512, 256, 128), (256, 512, 48), (384, 384, 640),
                      (300, 300, 64), (2048, 2048, 256)]:
        for causal in (False, True):
            for mask in (False, True):
                want = (not mask and sq >= 256
                        and gate(sq, sk, d, causal=causal))
                assert F.would_use_flash(sq, sk, d, causal, mask) == want
                assert not jax_attention.would_use_pallas(sq, sk, d, causal,
                                                          mask)


def test_train_step_runs_and_run_steps_loops(weights):
    model = port_model(weights)
    opt = optimizer.AdamW(LR, parameters=model.parameters())
    stepper = TrainStepper(model, lambda out, lab: model.loss(out, lab[0]),
                           opt)
    ids = torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (3, 2, 128)))
    losses = stepper.run_steps((ids,), (ids,))
    assert losses.shape == (3,) and torch.isfinite(losses).all()
    assert opt._step_count == 3
    loss, out = stepper.step((ids[0],), (ids[0],))
    assert loss.dtype == torch.float32 and out.shape == (2, 128, 256)


def test_left_out_options_raise():
    model = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    opt = optimizer.AdamW(LR, parameters=model.parameters())
    for kwargs in (dict(remat=True), dict(nonfinite_guard="skip_step"),
                   dict(comm_quant="int8")):
        with pytest.raises(NotImplementedError):
            TrainStepper(model, model.loss, opt, **kwargs)
    for option in ("use_recompute", "tensor_parallel", "sequence_parallel"):
        with pytest.raises(NotImplementedError, match=option):
            GPTForCausalLM(GPTConfig(**CFG, **{option: True}), device="cpu")
    with pytest.raises(NotImplementedError, match="grad_clip"):
        optimizer.AdamW(LR, parameters=model.parameters(), grad_clip=1.0)


def test_entry_points_need_a_card_or_cpu(weights):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        GPTForCausalLM(GPTConfig(**CFG))
    with pytest.raises(RuntimeError, match="CUDA"):
        gpt_params_from_jax(weights)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(reduction, label_smoothing):
    """The plain route of cross_entropy, ``ignore_index`` rows included
    (they give 0 and leave the mean's denominator)."""
    import paddle_tpu.nn.functional as jax_F

    rs = np.random.RandomState(4)
    logits = rs.randn(12, 40).astype(np.float32) * 3
    labels = rs.randint(0, 40, 12).astype(np.int64)
    labels[[2, 7]] = -100
    want = jax_F.cross_entropy(paddle.to_tensor(logits),
                               paddle.to_tensor(labels),
                               reduction=reduction,
                               label_smoothing=label_smoothing)
    got = F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                          reduction=reduction,
                          label_smoothing=label_smoothing)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(NotImplementedError):
        F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                        soft_label=True)


@pytest.mark.parametrize("mask_kind", ["bool", "additive"])
def test_sdpa_plain_route_with_mask_matches_jax(mask_kind):
    """A mask keeps attention on the plain composition at any length, as
    the reference routes it (masked scores at -1e9)."""
    import paddle_tpu.nn.functional as jax_F

    rs = np.random.RandomState(5)
    q, k, v = (rs.randn(2, 256, 2, 16).astype(np.float32) for _ in range(3))
    if mask_kind == "bool":
        mask = rs.rand(2, 2, 256, 256) > 0.3
    else:
        mask = (rs.randn(2, 2, 256, 256) * 0.5).astype(np.float32)
    want = jax_F.scaled_dot_product_attention(
        *(paddle.to_tensor(x) for x in (q, k, v)),
        attn_mask=paddle.to_tensor(mask), is_causal=True)
    got = F.scaled_dot_product_attention(
        *(torch.from_numpy(x) for x in (q, k, v)),
        attn_mask=torch.from_numpy(mask), is_causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               rtol=1e-5, atol=1e-5)


def test_dropout_scales_kept_entries_and_is_off_in_eval():
    x = torch.ones(4096)
    y = F.dropout(x, 0.25, training=True)
    kept = y != 0
    assert torch.all(y[kept] == 1 / 0.75)
    assert abs(kept.float().mean().item() - 0.75) < 0.05
    assert F.dropout(x, 0.25, training=False) is x
