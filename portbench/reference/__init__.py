"""The plain reference: plain PyTorch in fp32, independent of the program."""
