"""Exact GP model, NLML and priors."""
