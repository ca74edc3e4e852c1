"""Data substrate (numpy only): the synthetic corpus, its partition into
expert shards and the per-expert loaders."""
