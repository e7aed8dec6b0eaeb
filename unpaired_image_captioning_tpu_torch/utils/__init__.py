"""Host-side helpers of the port (copies of the JAX package's, which the
port never imports): text conversion, BPE, the HTML report, the word
cloud and the word-frequency scatter."""
