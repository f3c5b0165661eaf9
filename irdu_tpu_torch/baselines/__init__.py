"""The comparison baselines: DnCNN and DRUNet/UNet family, Restormer, SwinIR."""
