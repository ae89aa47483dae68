"""Metrics of the port: the framework (``metric_base``), the registry
(``metric_defaults``), FID and IS on the port's InceptionV3."""
