"""Synthetic PDE data made from a seed (Burgers 1D, Darcy 2D, diffusion 3D)."""
