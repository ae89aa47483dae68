"""The port's networks: StyleGAN2's generator and discriminator, LPIPS,
InceptionV3 and the metrics' feature nets."""
