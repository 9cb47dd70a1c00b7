"""Deployment configurations."""
