"""Whole-trial inference of the port: the Predictor, the fold blend,
evaluation, submissions and ensembles."""
