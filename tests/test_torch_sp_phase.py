"""chip_smoke.py's phase 11 (``sp_phase``) rehearsed on the CPU: every SP
case in worlds of 1, 2 and 4 gloo ranks (one spawned process per rank) at
N=512, where each case keeps its regime (halo SP at W=128, the ring's full
rotation at W=N, skip-ahead with the sink partial at W=3N/8, the sink
broadcast, Ulysses plain and packed), in fp32 through the kernels' plain
versions: its gates pass, the ranks launch no kernel, and each rank's
output and gradients equal the single-process attention's (fp32, the JAX
tests' 1e-4)."""

import _torch_cores  # noqa: F401 (shares the cores among workers)
import chip_smoke


def test_chip_smoke_sp_phase_on_cpu():
    report, launches, errors = chip_smoke.sp_phase("cpu", n=512)
    assert errors == []
    assert set(launches.values()) == {0}
    worlds = sorted({int(r["case"].split("world=")[1].split()[0])
                     for r in report})
    assert worlds == [1, 2, 4]
    assert len(report) == sum(len(c[3]) for c in chip_smoke.SP_CASES)
    for row in report:
        for rank in row["ranks"]:
            assert rank["finite"]
            assert rank["out"]["err"] <= 1e-4, row["case"]
            for g in ("dq", "dk", "dv", "ds_aux"):
                assert rank[g]["rel_err"] <= 1e-4, (row["case"], g)
