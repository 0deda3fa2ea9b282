"""Datasets, batching and host->device prefetching of the port."""
