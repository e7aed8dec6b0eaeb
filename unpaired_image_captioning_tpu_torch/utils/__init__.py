"""Host-side helpers of the port (copies of the JAX package's, which the
port never imports)."""
