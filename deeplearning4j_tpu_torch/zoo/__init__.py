"""Model zoo of the port: the Transformer-LM (inference)."""
