"""Model zoo of the port: the Transformer-LM and ResNet-50."""
