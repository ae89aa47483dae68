"""Metrics of the port: the framework (``metric_base``), the registry
(``metric_defaults``) and every metric it names: FID, IS, precision and
recall, PPL, linear separability, mode counts and KL."""
