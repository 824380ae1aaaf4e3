"""The port's multi-process smoke harness (``pocomc_tpu_torch.parallel.smoke``)
on the CPU over gloo, at the matrix of the JAX package's
``tests/test_multihost.py`` with one device a process (the port's model):

  * 2 ranks, every case: the sharded reduction and gather, the black-box
    fan-out, the sweep on each rank's rows, the device and host loops, and
    a ``save_every`` checkpoint resumed by a fresh sampler;
  * 4 ranks, the device loop and the host loop (the power-of-two batches
    divide the mesh: no replication fallback);
  * 3 ranks, the host loop and the resume (the power-of-two batches do not
    divide it: the fallback must fire).

Every rank must print its MULTIHOST-OK line and every checksum must agree
(``launch`` raises otherwise).
"""

import pytest

from pocomc_tpu_torch.parallel.smoke import launch, line_stats


@pytest.mark.parametrize("nproc,cases", [
    (2, "all"),
    (4, "dev,host"),
    (3, "host,resume"),
])
def test_process_mesh_end_to_end(nproc, cases):
    lines = launch(num_processes=nproc, n_local=1, cases=cases, timeout=150.0)
    assert len(lines) == nproc
    stats = [line_stats(ln) for ln in lines]
    for ln, st in zip(lines, stats):
        assert f"devices={nproc}" in ln and "nan" not in ln
        assert st["backend"] == "gloo" and st["device"] == "cpu"
        if cases == "all":
            # each rank's callback and sweep saw its own 16 of 32 rows; two
            # all_reduce rounds a sweep step, plus the start's and the exit's
            assert st["local_batch_max"] == 16
            assert st["collectives_per_step"] <= 2 + 4 / st["sweep_steps"]
            assert {"run_logz_dev", "run_logz_host", "run_logz_resume"} <= set(st)
        if "host" in cases:
            assert st["host_sweep_rows_max"] <= 16
            assert (st["host_fallbacks"] > 0) == (nproc == 3)
        if "resume" in cases:
            assert "run_logz_resume" in st
