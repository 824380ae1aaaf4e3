"""The rest of a run with the timed path broken underneath: ``correct``
comes out false for each fault a cell can have. The faults: a step that
returns its state unchanged (the sweep's accept step; phase B's optimizer
step), half of the batch left out with the mean taken over the rest (the
likelihood, phase B's training batch, K5's inverse), and an answer
altered where it is produced (phase A's temperature, K2's and K1's
outputs, K2's gradient, AdamW's step, K5's log-determinant). Both cells
run on one chip, so no exchange between chips can be left out."""

import pytest
import torch

from conftest import run_tiny


def _unchanged_sweep_step(mp):
    """The step's particles come back as they went in (its counters and
    statistics move on)."""
    import dataclasses
    from pocomc_tpu_torch.mcmc import Sweep
    orig = Sweep.accept_update
    keep = ("u", "x", "logdetj", "logl", "logp", "theta", "logdetj_flow")

    def step(self, st, prop, logl_p, beta, geom):
        new, acc = orig(self, st, prop, logl_p, beta, geom)
        return dataclasses.replace(new, **{k: getattr(st, k) for k in keep}), acc
    mp.setattr(Sweep, "accept_update", step)


def _unchanged_optimizer_step(mp):
    mp.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)


def _half_likelihood_batch(mp):
    from pocomc_tpu_torch import mcmc, sampler
    orig = mcmc.make_loglike

    def make(fn):
        def half(x):
            out = fn(x[: x.shape[0] // 2])
            return torch.cat([out, out.mean().expand(x.shape[0] - out.shape[0])])
        return orig(half)
    mp.setattr(mcmc, "make_loglike", make)
    mp.setattr(sampler, "make_loglike", make, raising=False)


def _altered_beta(mp):
    from pocomc_tpu_torch import phases
    orig = phases.reweight

    def reweight(*a, **k):
        out = orig(*a, **k)
        out["beta"] = torch.clamp(out["beta"] * 1.01 + 1e-3, max=1.0)
        return out
    mp.setattr(phases, "reweight", reweight)


def _altered_flow_output(name, item):
    def plant(mp):
        from pocomc_tpu_torch.models import flow
        orig = getattr(flow, name)

        def altered(*a, **k):
            out = list(orig(*a, **k))
            out[item] = out[item].clone()
            out[item].view(-1)[0] += 0.05
            return tuple(out)
        mp.setattr(flow, name, altered)
    return plant


def _half_training_batch(mp):
    """Each training step's loss the mean over the first half of its batch."""
    from pocomc_tpu_torch.models.flow import Flow
    orig = Flow._loss_fn

    def half(self, xb, wb, *a, **k):
        if torch.is_grad_enabled():
            xb, wb = xb[: xb.shape[0] // 2], wb[: wb.shape[0] // 2]
        return orig(self, xb, wb, *a, **k)
    mp.setattr(Flow, "_loss_fn", half)


class _Twice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, ladj):
        return z.clone(), ladj.clone()

    @staticmethod
    def backward(ctx, gz, gl):
        return 2.0 * gz, 2.0 * gl


def _scaled_k2_gradient(mp):
    """K2's backward gives twice the gradient (its outputs unchanged)."""
    from pocomc_tpu_torch.models import flow
    orig = flow.made_rqs_forward

    def scaled(*a, **k):
        z, ladj = orig(*a, **k)
        return _Twice.apply(z, ladj) if torch.is_grad_enabled() else (z, ladj)
    mp.setattr(flow, "made_rqs_forward", scaled)


def _doubled_adamw_step(mp):
    """AdamW steps at twice the learning rate it was given."""
    orig = torch.optim.AdamW.step

    def step(self, closure=None):
        for group in self.param_groups:
            group["lr"] *= 2.0
        try:
            return orig(self, closure)
        finally:
            for group in self.param_groups:
                group["lr"] /= 2.0
    mp.setattr(torch.optim.AdamW, "step", step)


def _half_k5_inverse(mp):
    from pocomc_tpu_torch.models import flow
    orig = flow.coupling_inverse

    def half(z, *a, **k):
        x, ladj = orig(z, *a, **k)
        n = z.shape[0] // 2
        return torch.cat([x[:n], z[n:]]), torch.cat([ladj[:n], ladj[:n].mean().expand(
            z.shape[0] - n)])
    mp.setattr(flow, "coupling_inverse", half)


FAULTS = {
    "gauss50.smc": {
        "sweep step unchanged": (_unchanged_sweep_step, "accept_flips"),
        "optimizer step unchanged": (_unchanged_optimizer_step, "fit_change_gap"),
        "half the training batch": (_half_training_batch, "fit_grad_gap"),
        "K2's gradient doubled": (_scaled_k2_gradient, "fit_grad_gap"),
        "AdamW's step doubled": (_doubled_adamw_step, "fit_change_gap"),
        "half the likelihood batch": (_half_likelihood_batch, "logl_gap"),
        "phase A's temperature altered": (_altered_beta, "beta_gap"),
        "K2's output altered": (_altered_flow_output("made_rqs_forward", 0), "k2_z_gap"),
        "K1's output altered": (_altered_flow_output("ar_inverse", 0), "k1_x_gap"),
    },
    "rosen50_nsfc12.sweep": {
        "sweep step unchanged": (_unchanged_sweep_step, "accept_flips"),
        "half of K5's inverse batch": (_half_k5_inverse, "k5inv_x_gap"),
        "half the likelihood batch": (_half_likelihood_batch, "logl_gap"),
        "K5's log-det altered": (_altered_flow_output("coupling_inverse", 1), "k5inv_ladj_gap"),
    },
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in FAULTS for f in FAULTS[c]])
def test_fault_makes_the_run_incorrect(cell, fault, monkeypatch):
    plant, number = FAULTS[cell][fault]
    plant(monkeypatch)
    r = run_tiny(cell, seed=11, seconds=2.0)
    assert not r["correct"]
    row = r["checks"][number]
    assert not row["value"] <= row["limit"], (number, row)
