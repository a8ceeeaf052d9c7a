"""Synthetic request streams and frequency priors."""
