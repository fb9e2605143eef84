"""LM substrate: attention (dense and the flash kernel), layers and the
dense decoder family."""
