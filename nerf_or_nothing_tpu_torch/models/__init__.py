"""The MipNeRF MLP and model."""
