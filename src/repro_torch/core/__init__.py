"""Core of the port: configuration, the fold-in inference body, the
single-shard reducer and perplexity."""
