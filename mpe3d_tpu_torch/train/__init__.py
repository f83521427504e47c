"""Training: the lifter's and the matcher's datasets and trainers, and the
matcher's scenes synthesised on the device."""
