"""Datasets and the prefetching batch loader."""
