"""Datasets of the port: the TFRecord reader and writer, the synthetic set
and the prefetcher."""
