"""Host-side data plumbing of the port (numpy copies of the reference's
generators, batching and vocabulary map)."""
