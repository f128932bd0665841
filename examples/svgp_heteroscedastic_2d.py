"""SVGP-heteroscedastic uncertainty after transport (reference
``example/2D/torch/surface_generalization_svgp_heteroschedastic_uncertainty.py``,
246 LoC): transport the policy with the sparse variational
GP transport (20 inducing points, reference line 123), fit an aleatoric GP
on the SVGP's transported velocity-variance labels (lines 143-155), and
combine with the epistemic std of the re-fit C*Matern(2.5)+White dynamics
GP (lines 158-171):

    sigma_hetero(x)^2 = sigma_epistemic(x)^2 + sigma_aleatoric(x)^2.

Run:  python examples/svgp_heteroscedastic_2d.py [--cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--data", default="/root/reference/example/2D/data/example.npz")
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--inducing", type=int, default=20)
    args = p.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    import gaussian_process_transportation_tpu as gpt
    from gaussian_process_transportation_tpu import kernels as K
    from gaussian_process_transportation_tpu.models import exact_gp as core
    from gaussian_process_transportation_tpu.transport import heteroscedastic as het
    from gaussian_process_transportation_tpu.transport.variants import SVGPTransport

    data = np.load(args.data)
    # reference scale: 100-point demo, 20-point distributions (lines 29-31)
    X = gpt.resample(jnp.asarray(data["demo"]), num_points=100)
    S = gpt.resample(jnp.asarray(data["floor"]), num_points=20)
    S1 = gpt.resample(jnp.asarray(data["newfloor"]), num_points=20)
    dX = jnp.diff(X, axis=0)
    X = X[:-1]  # reference lines 33-39: drop the last (delta-less) sample

    tr = SVGPTransport()
    tr.source_distribution, tr.target_distribution = S, S1
    tr.training_traj, tr.training_delta = X, dX
    print("Transporting the dynamical system on the new surface (SVGP)")
    tr.fit_transportation(num_epochs=args.epochs, num_inducing=args.inducing)
    tr.apply_transportation()
    X1, dX1 = tr.training_traj, tr.training_delta
    print("transported; SVGP aleatoric var range:",
          float(jnp.min(tr.var_vel_transported)),
          float(jnp.max(tr.var_vel_transported)))

    # aleatoric GP on sqrt(var_vel_transported) labels (reference 143-150:
    # C(sqrt(0.1))*RBF(4)+White(0.01) on the std labels)
    gp_alea = het.fit_aleatoric_gp(X1, tr.var_vel_transported, n_restarts=2)
    # dynamics GP on the transported rollout: the canonical
    # C(sqrt(0.1))*Matern(nu=2.5)+White policy-DS kernel (reference 159)
    k_dyn = (
        K.Constant(float(np.sqrt(0.1)))
        * K.Matern(jnp.ones(2), nu=2.5, bounds=(10.0, 500.0))
        + K.White(0.01)
    )
    gp_dyn = core.fit(k_dyn, X1, dX1, n_restarts=2)

    # the reference's 100x100 grid window (lines 73-76, 152-153)
    gx = jnp.linspace(float(X1[:, 0].min()) - 10, float(X1[:, 0].max()) + 20, 40)
    gy = jnp.linspace(float(X1[:, 1].min()) - 5, float(X1[:, 1].max()) + 30, 40)
    GX, GY = jnp.meshgrid(gx, gy)
    grid = jnp.column_stack([GX.ravel(), GY.ravel()])
    mean, sig_het, sig_alea = het.heteroscedastic_field(gp_dyn, gp_alea, grid)
    print(f"combined field on 40x40 grid: sigma_hetero in "
          f"[{float(sig_het.min()):.3f}, {float(sig_het.max()):.3f}], "
          f"sigma_aleatoric in [{float(sig_alea.min()):.3f}, {float(sig_alea.max()):.3f}]")
    # The SVGP's transportation uncertainty concentrates where the surface
    # deformed (the derivative posterior's variance grows with the warp) —
    # the composition's headline claim in the reference figure.
    near_surface = (
        jnp.linalg.norm(grid[:, None, :] - jnp.asarray(S1)[None], axis=2).min(1) < 5
    )
    print("mean sigma_aleatoric near surface vs far:",
          float(sig_alea[near_surface].mean()), "vs",
          float(sig_alea[~near_surface].mean()))


if __name__ == "__main__":
    main()
