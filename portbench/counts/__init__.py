"""Operation and byte counts and the card's peaks: the yardstick of the
rooflines and of the model FLOP shares."""
