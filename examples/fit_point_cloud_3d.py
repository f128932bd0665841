"""SVGP surface completion on the four RECORDED point clouds (reference
``example/3D/torch/fit_point_could.py``): fit z(x, y) with
a 1000-inducing-point sparse variational GP per object and evaluate the
completed surface on a 100x100 grid over the cloud's xy bounding box
(the scale of ``sensors/surface_pointcloud_detector.py:149``).

Run:  python examples/fit_point_cloud_3d.py [--cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OBJECTS = [
    "dustbin_cover_point_cloud_distribution",
    "pan_point_cloud_distribution",
    "white_towelholder_point_cloud_distribution",
    "wood_plate_point_cloud_distribution",
]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--data", default="/root/reference/example/3D/torch/data")
    p.add_argument("--inducing", type=int, default=1000)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--grid", type=int, default=100)
    p.add_argument("--objects", nargs="*", default=OBJECTS)
    args = p.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from gaussian_process_transportation_tpu.data.datasets import complete_surface
    from gaussian_process_transportation_tpu.models.svgp import (
        StochasticVariationalGaussianProcess,
    )

    for name in args.objects:
        path = os.path.join(args.data, name + ".npz")
        cloud = np.load(path)["point_cloud_distribution"]
        print(f"{name}: {cloud.shape[0]} recorded points")
        surface = complete_surface(
            cloud, grid_n=args.grid, num_inducing=args.inducing,
            num_epochs=args.epochs,
        )
        assert surface.shape == (args.grid * args.grid, 3)
        assert np.isfinite(surface).all()
        # fit quality at the recorded xy locations (the cloud itself)
        xy, z = cloud[:, :2], cloud[:, 2:3]
        model = StochasticVariationalGaussianProcess(
            xy, z, num_inducing=min(args.inducing, len(xy)), seed=0
        )
        model.fit(num_epochs=args.epochs)
        z_hat = np.asarray(model.predict(xy))[:, 0]
        rmse = float(np.sqrt(np.mean((z_hat - z[:, 0]) ** 2)))
        span = float(z.max() - z.min() + 1e-12)
        print(f"  completed z in [{surface[:, 2].min():.4f}, "
              f"{surface[:, 2].max():.4f}]  train-RMSE {rmse:.4f} "
              f"({100 * rmse / span:.1f}% of z-span)")


if __name__ == "__main__":
    main()
