"""Designs, partitions and prior draws (``designs``).  MCMC comes later."""

from pygpr_torch.sample.designs import (
    Matern1,
    Sobol,
    Uniform,
    assign_clusters,
    cluster_samples,
    euclidean_dist,
    sample_gp,
)
