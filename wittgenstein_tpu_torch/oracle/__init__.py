"""Host-side pieces of the oracle the batched protocols are built from."""
