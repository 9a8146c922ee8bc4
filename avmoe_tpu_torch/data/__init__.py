"""Data readers, transforms and the prefetching batch loader."""
