"""The port's optimizers against gnn_tpu.optim, step for step.

Fixed gradients (numpy, seeded) drive both: ten steps for Adam/AdamW, three
for SGD and for gradient clipping in front of Adam. The parameters must
agree to rtol=1e-6 after every step (the same float32 arithmetic in the
same order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu import optim as jax_optim
from gnn_tpu_torch.optim import SGD, Adam, AdamW, clip_by_global_norm


@pytest.mark.parametrize(
    "kind,weight_decay",
    [("adam", 0.0), ("adam", 5e-4), ("adamw", 1e-2), ("adamw", 0.0)],
)
def test_adam_matches_jax_step_for_step(rng, kind, weight_decay):
    shapes = {"w": (7, 5), "b": (5,)}
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [
        {k: (rng.normal(size=s) * 10.0 ** rng.integers(-3, 2)).astype(np.float32) for k, s in shapes.items()}
        for _ in range(10)
    ]
    lr = 0.01
    if kind == "adam":
        jopt = jax_optim.adam(lr, weight_decay=weight_decay)
        topt_cls = lambda ps: Adam(ps, lr=lr, weight_decay=weight_decay)
    else:
        jopt = jax_optim.adamw(lr, weight_decay=weight_decay)
        topt_cls = lambda ps: AdamW(ps, lr=lr, weight_decay=weight_decay)

    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = jopt.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    topt = topt_cls(list(tparams.values()))
    for step, g in enumerate(grads):
        upd, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = jax_optim.apply_updates(jparams, upd)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        topt.step()
        for k in shapes:
            np.testing.assert_allclose(
                tparams[k].detach().numpy(), np.asarray(jparams[k]), rtol=1e-6, atol=0,
                err_msg=f"step {step} param {k}",
            )


def test_adam_skips_params_without_grad():
    p = torch.nn.Parameter(torch.ones(3))
    q = torch.nn.Parameter(torch.ones(3))
    opt = Adam([p, q], lr=0.1)
    p.grad = torch.ones(3)
    opt.step()
    assert torch.all(p < 1) and torch.all(q == 1)


@pytest.mark.parametrize("cls", [Adam, AdamW])
def test_adam_leaves_that_skip_steps_keep_their_own_count(cls):
    """One optimizer over leaves whose gradients are missing at some steps
    takes, for each leaf, bitwise the steps of an optimizer over that leaf
    alone: each leaf's bias correction follows its own step count."""
    gen = torch.Generator().manual_seed(0)
    shapes = [(4, 3), (3,), ()]
    init = [torch.randn(s, generator=gen) for s in shapes]
    together = [torch.nn.Parameter(t.clone()) for t in init]
    alone = [torch.nn.Parameter(t.clone()) for t in init]
    opt = cls(together, lr=0.05, weight_decay=1e-2)
    opts = [cls([p], lr=0.05, weight_decay=1e-2) for p in alone]
    for step in range(6):
        for i, (a, b) in enumerate(zip(together, alone)):
            skip = (i == 1 and step in (1, 2)) or (i == 2 and step == 4)
            g = None if skip else torch.randn(a.shape, generator=gen)
            a.grad = None if g is None else g.clone()
            b.grad = None if g is None else g.clone()
        opt.step()
        for o in opts:
            o.step()
    for a, b in zip(together, alone):
        assert torch.equal(a, b)
    assert [opt.state[p]["step"] for p in together] == [6, 4, 5]


SHAPES = {"w": (7, 5), "b": (5,), "eps": ()}


def _drive(rng, jopt, make_topt, steps=3, clip=0.0, scale=1.0):
    """Run both optimizers over the same gradients; compare after each step."""
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = jopt.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(np.array(v))) for k, v in init.items()}
    topt = make_topt(list(tparams.values()))
    for step in range(steps):
        g = {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in SHAPES.items()}
        upd, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = jax_optim.apply_updates(jparams, upd)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(np.array(g[k]))
        if clip:
            clip_by_global_norm(tparams.values(), clip)
        topt.step()
        for k in SHAPES:
            np.testing.assert_allclose(
                tparams[k].detach().numpy(), np.asarray(jparams[k]), rtol=1e-6, atol=0,
                err_msg=f"step {step} param {k}",
            )


@pytest.mark.parametrize(
    "kwargs",
    [
        {},
        {"momentum": 0.9},
        {"momentum": 0.9, "nesterov": True},
        {"weight_decay": 5e-4},
        {"momentum": 0.9, "weight_decay": 5e-4},
        {"momentum": 0.8, "dampening": 0.3},
        {"momentum": 0.8, "dampening": 0.3, "weight_decay": 1e-2},
    ],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "plain",
)
def test_sgd_matches_jax_step_for_step(rng, kwargs):
    _drive(rng, jax_optim.sgd(0.05, **kwargs), lambda ps: SGD(ps, lr=0.05, **kwargs))


def test_sgd_first_step_starts_from_a_zero_velocity():
    """v1 = (1 - dampening) * g, where torch.optim.SGD would take v1 = g."""
    p = torch.nn.Parameter(torch.ones(3))
    p.grad = torch.full((3,), 2.0)
    SGD([p], lr=0.1, momentum=0.9, dampening=0.5).step()
    torch.testing.assert_close(p.detach(), torch.full((3,), 1.0 - 0.1 * 0.5 * 2.0))
    q = torch.nn.Parameter(torch.ones(3))
    q.grad = torch.full((3,), 2.0)
    torch.optim.SGD([q], lr=0.1, momentum=0.9, dampening=0.5).step()
    assert not torch.allclose(p, q)


@pytest.mark.parametrize("kwargs", [{"nesterov": True}, {"nesterov": True, "momentum": 0.9, "dampening": 0.1}])
def test_sgd_nesterov_needs_momentum_and_no_dampening(kwargs):
    with pytest.raises(ValueError, match="Nesterov"):
        SGD([torch.nn.Parameter(torch.ones(1))], lr=0.1, **kwargs)
    with pytest.raises(ValueError, match="Nesterov"):
        jax_optim.sgd(0.1, **kwargs)


def test_sgd_skips_params_without_grad():
    p, q = torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(3), requires_grad=False)
    opt = SGD([p, q], lr=0.1, momentum=0.9, weight_decay=0.1)
    p.grad = torch.ones(3)
    opt.step()
    assert torch.all(p < 1) and torch.all(q == 1)


@pytest.mark.parametrize("scale", [10.0, 0.01], ids=["clipped", "below-the-norm"])
@pytest.mark.parametrize("base", ["adam", "sgd"])
def test_clip_by_global_norm_then_optimizer_matches_jax(rng, base, scale):
    if base == "adam":
        jbase, make = jax_optim.adam(0.01, weight_decay=5e-4), lambda ps: Adam(ps, lr=0.01, weight_decay=5e-4)
    else:
        jbase, make = jax_optim.sgd(0.05, momentum=0.9), lambda ps: SGD(ps, lr=0.05, momentum=0.9)
    jopt = jax_optim.chain(jax_optim.clip_by_global_norm(1.0), jbase)
    _drive(rng, jopt, make, clip=1.0, scale=scale)


def test_clip_by_global_norm_scales_all_gradients_together():
    ps = [torch.nn.Parameter(torch.zeros(2)), torch.nn.Parameter(torch.zeros(())), torch.nn.Parameter(torch.zeros(1))]
    ps[0].grad, ps[1].grad = torch.tensor([3.0, 0.0]), torch.tensor(4.0)  # norm 5; the third has no gradient
    norm = clip_by_global_norm(ps, 1.0)
    assert norm.item() == pytest.approx(5.0)
    torch.testing.assert_close(ps[0].grad, torch.tensor([0.6, 0.0]))
    torch.testing.assert_close(ps[1].grad, torch.tensor(0.8))
    assert clip_by_global_norm(ps, 10.0).item() == pytest.approx(1.0)
    torch.testing.assert_close(ps[1].grad, torch.tensor(0.8))  # below the norm: untouched
    assert clip_by_global_norm([ps[2]], 1.0).item() == 0.0
