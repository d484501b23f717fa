"""Models of the port: UNet, image-VAE encoder, seg-VAE decoder, converters."""
