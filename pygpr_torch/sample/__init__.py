"""Designs, partitions and prior draws (``designs``), MCMC over the
hyperparameters (``mcmc``: RWM and HMC; ``nuts``) and elliptical slice
sampling of latent functions (``ess``)."""

from pygpr_torch.sample.designs import (
    Matern1,
    Sobol,
    Uniform,
    assign_clusters,
    cluster_samples,
    euclidean_dist,
    sample_gp,
)
from pygpr_torch.sample.ess import (
    ESSResult,
    predictive_latent_mixture,
    sample_latent,
)
from pygpr_torch.sample.nuts import (
    NUTSResult,
    run_nuts,
    sample_posterior_nuts,
)
from pygpr_torch.sample.mcmc import (
    MCMCResult,
    effective_sample_size,
    log_posterior_fn,
    posterior_moments,
    predictive_mixture,
    sample_posterior,
    sample_posterior_hmc,
    split_rhat,
)
