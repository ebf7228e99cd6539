"""Model constants shared by the cascade (file names, SSD options, ROI
scales and landmark index maps)."""
