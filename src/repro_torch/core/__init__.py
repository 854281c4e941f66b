"""Core of the port: configuration, the fold-in inference body, the
single-shard reducer, perplexity, and the paper's comparators (``vb``,
``gibbs``)."""
