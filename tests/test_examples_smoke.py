"""Smoke tier for every `examples/*.py`: each script's
``main()`` runs end-to-end at tiny sizes on CPU in its own subprocess,
figures to a tmpdir — breakage in the example layer becomes a test
failure instead of silent rot.

Slow-marked: ~15 subprocess interpreter+trace starts on a 2-core box.
"""
import os
import subprocess
import sys

import pytest

from conftest import reference_available

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples")

# script -> (extra tiny-size args, needs /root/reference data)
CASES = {
    "comparison_surfaces.py": ([], True),
    "diffeomorphism_2d.py": (["--trials", "2"], True),
    "enn_heteroscedastic_2d.py": (["--epochs", "5"], True),
    "fit_point_cloud_3d.py": (
        ["--inducing", "64", "--epochs", "2", "--grid", "10",
         "--objects", "pan_point_cloud_distribution"], True),
    "gmm_transport_2d.py": ([], True),
    "heteroscedastic_2d.py": ([], True),
    "large_n_hyperopt.py": (["--n", "384", "--cap", "256", "--maxiter", "2"], False),
    "lasa_ds.py": ([], True),
    "multi_reference_frames.py": (["--reps", "1"], True),
    "obstacle_avoidance_ds.py": ([], False),
    "obstacle_flow_field_2d.py": ([], False),
    "paper_figures.py": ([], True),
    "pod_scale_ensembles.py": (["--members", "16", "--chains", "2"], False),
    "surface_generalization_2d.py": ([], True),
    "surface_generalization_3d.py": (["--subsample", "150"], True),
    "svgp_heteroscedastic_2d.py": (["--epochs", "10"], True),
    "svgp_transport_2d.py": ([], True),
}


def test_every_example_has_a_smoke_case():
    on_disk = sorted(f for f in os.listdir(EXAMPLES) if f.endswith(".py"))
    assert on_disk == sorted(CASES), "examples/ and smoke CASES out of sync"


@pytest.mark.slow
@pytest.mark.parametrize("script", sorted(CASES), ids=lambda s: s[:-3])
def test_example_smoke(script, tmp_path):
    args, needs_ref = CASES[script]
    if needs_ref and not reference_available():
        pytest.skip("reference data not mounted")
    env = dict(os.environ)
    env["MPLBACKEND"] = "Agg"
    env.pop("GPT_GPU_TESTS", None)
    extra = list(args)
    if script == "paper_figures.py":
        extra += ["--out", str(tmp_path / "fig.png")]
    if script == "comparison_surfaces.py":
        extra += ["--out", str(tmp_path)]
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, script), "--cpu"] + extra,
        cwd=tmp_path,
        env=env,
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert proc.returncode == 0, (
        f"{script} failed:\nstdout:\n{proc.stdout[-2000:]}\n"
        f"stderr:\n{proc.stderr[-2000:]}"
    )
