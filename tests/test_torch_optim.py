"""The port's Adam/AdamW against gnn_tpu.optim.adam/adamw, step for step.

Ten fixed gradients (numpy, seeded) drive both; the parameters must agree to
rtol=1e-6 after every step (the same float32 arithmetic in the same order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu import optim as jax_optim
from gnn_tpu_torch.optim import Adam, AdamW


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
