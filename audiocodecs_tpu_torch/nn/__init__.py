"""Neural-network building blocks of the port ([B, C, T] inside stacks)."""
