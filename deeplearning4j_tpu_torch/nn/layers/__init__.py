"""Layer configs of the port: ``init`` / ``apply`` on tensors."""
