"""chip_smoke.py's plan of kernel checks, on the CPU.

Phases 3-4, 13 (a) and 14 (b) of ``chip_smoke.py`` hold every CUDA kernel
against its plain version or float64 on the card, at the (flow, d, n,
bins) of ``chip_smoke.CHECK_PLAN``, which the phases iterate over. Here
the plan must hold every check that the script made when the plan was
written (listed below, not derived from the script's constants), at the
tolerances it took then: a later change that drops a check, or moves a
tolerance, fails on the CPU before it reaches a card."""

import pytest

import chip_smoke

NSF_SHAPES = [("nsf6", 10, 37), ("nsf6", 10, 256), ("nsf6", 10, 1024), ("nsf6", 10, 2048),
              ("nsf6", 10, 4096), ("nsf6", 50, 256), ("nsf6", 50, 4096), ("nsf3", 2, 256),
              ("nsf3", 2, 2048), ("nsf3", 4, 128), ("nsf3", 4, 512)]
MENU_SHAPES = [("maf6", 10, 37), ("maf6", 10, 256), ("maf6", 10, 1024), ("maf6", 10, 4096),
               ("nsfc6", 10, 37), ("nsfc6", 10, 256), ("nsfc6", 10, 1024), ("nsfc6", 10, 4096),
               ("maf6", 50, 256), ("maf6", 50, 4096), ("nsfc12", 50, 256), ("nsfc12", 50, 1024),
               ("nsfc12", 50, 4096), ("nsfc12", 50, 65536)]
GRAD_SHAPES = [("nsf6", 10, 37), ("nsf6", 10, 256), ("nsf6", 10, 1024), ("nsf6", 10, 4096),
               ("nsf3", 4, 128), ("nsf6", 50, 256), ("nsf6", 50, 4096), ("maf6", 10, 256),
               ("maf6", 50, 4096), ("nsf3", 342, 64), ("maf3", 342, 64), ("nsfc6", 10, 256),
               ("nsfc6", 10, 1024), ("nsfc12", 50, 256), ("nsfc12", 50, 4096)]
BINS = (16, 17, 32, 64, 128, 512, 1000)
TIMED = (16, 32)

CHECKS = (
    [("3-4", "check_spline_made", f, d, n, 8) for f, d, n in NSF_SHAPES]
    + [("3-4", "check_menu", f, d, n, 8) for f, d, n in MENU_SHAPES]
    + [("13 (a)", "check_gradient", f, d, n, 8) for f, d, n in GRAD_SHAPES]
    + [("14 (b)", "check_spline_made", "nsf6", 10, 256, b) for b in BINS]
    + [("14 (b)", "check_spline_made", f, d, n, b) for b in TIMED
       for f, d, n in (("nsf6", 10, 2048), ("nsf6", 10, 4096), ("nsf6", 50, 1024),
                       ("nsf3", 342, 64))]
    + [("14 (b)", "check_menu", "nsfc6", 10, 256, b) for b in BINS]
    + [("14 (b)", "check_menu", "nsfc12", 50, 1024, b) for b in TIMED]
    + [("14 (b)", "check_gradient", f, 10, 256, b) for f in ("nsf6", "nsfc6") for b in BINS]
    + [("14 (b)", "check_gradient", f, 50, 1024, b) for b in TIMED
       for f in ("nsf6", "nsfc12")])


@pytest.mark.parametrize("phase", ["3-4", "13 (a)", "14 (b)"])
def test_plan_holds_every_check_of_the_phase(phase):
    """Every check of the phase in the earlier run is in the plan, once."""
    want = [c for c in CHECKS if c[0] == phase]
    plan = [c for c in chip_smoke.CHECK_PLAN if c[0] == phase]
    assert len(plan) == len(set(plan))
    assert sorted(set(want) - set(plan)) == []


def test_plan_is_what_the_phases_read():
    """``planned`` gives the phases the plan's checks, each family's in the
    plan's order, and every check runs one of the three families."""
    families = {"check_spline_made", "check_menu", "check_gradient"}
    assert {c[1] for c in chip_smoke.CHECK_PLAN} <= families
    for phase in ("3-4", "13 (a)", "14 (b)"):
        for family in families:
            assert chip_smoke.planned(phase, family) == [
                c[2:] for c in chip_smoke.CHECK_PLAN if c[:2] == (phase, family)]
        assert all(callable(getattr(chip_smoke, c[1])) for c in chip_smoke.CHECK_PLAN)


def test_bins_of_phase_14_are_every_library_route():
    """Phase 14 holds 16 bins (the most of a compiled library) and past it
    the library of run-time bins from its fewest bins (17) to the most a
    spline holds (1000), and times 16 and 32."""
    assert chip_smoke.CHECKED_BINS == BINS
    assert chip_smoke.TIMED_BINS == TIMED
    assert chip_smoke.QUICK_BINS == 32


def test_tolerances_are_those_of_the_earlier_run():
    """The stated tolerances the checks take: TOL by width, a coupling
    stack's (values, log-dets) atol, the 1000-bin limits and the gradient
    rows of the menu's checks."""
    assert chip_smoke.TOL == {10: dict(rtol=1e-5, atol=1e-5, ladj=1e-4, grad=1e-4),
                              50: dict(rtol=1e-4, atol=1e-4, ladj=2e-3, grad=1e-3)}
    assert chip_smoke.COUPLING_TOL == {10: (5e-5, 5e-4), 50: (5e-4, 1e-2)}
    assert chip_smoke.NARROW_TOL == {1000: dict(ladj=3e-4, grad=6e-4)}
    assert chip_smoke.MENU_GRAD_ROWS == {10: 1024, 50: 256}
    assert chip_smoke.narrow_tol(chip_smoke.TOL[10], 1000) == dict(
        rtol=1e-5, atol=1e-5, ladj=3e-4, grad=6e-4)
    assert chip_smoke.narrow_tol(chip_smoke.TOL[10], 512) == chip_smoke.TOL[10]


def test_rules_give_their_verdicts():
    """The rules the phases and the card tests share return their verdicts
    without ending the run: an element past the plain version but within
    the tolerance of float64 passes the values rule, one past both fails;
    the float64 rule takes 4x the plain version's distance where larger;
    the gradient rule is max |diff| over the largest of each tensor."""
    import torch
    exact = torch.tensor([1.0, 2.0], dtype=torch.float64)
    plain = torch.tensor([1.0, 2.0 + 3e-5])
    ok, out = chip_smoke.values_verdict(torch.tensor([1.0, 2.0]), plain, exact, 0.0, 1e-5)
    assert ok and out["held_by_float64"] == 1 and out["past_both"] == 0
    ok, out = chip_smoke.values_verdict(torch.tensor([1.0, 2.0 + 6e-5]), plain, exact, 0.0,
                                        1e-5)
    assert not ok and out["past_both"] == 1
    ok, out = chip_smoke.float64_verdict(torch.tensor([1.0, 2.0 + 1e-4]), plain, exact, 1e-5)
    assert ok and out["limit"] == pytest.approx(4 * 3e-5, rel=1e-2)
    assert not chip_smoke.float64_verdict(torch.tensor([1.0, 2.0 + 2e-4]), plain, exact,
                                          1e-5)[0]
    ok, errs = chip_smoke.grad_verdict([torch.tensor([2.0, 1.0001])], [torch.tensor([2.0, 1.0])],
                                       1e-4)
    assert ok and errs[0] == pytest.approx(5e-5, rel=1e-2)
    assert not chip_smoke.grad_verdict([torch.tensor([2.0, 1.001])], [torch.tensor([2.0, 1.0])],
                                       1e-4)[0]
