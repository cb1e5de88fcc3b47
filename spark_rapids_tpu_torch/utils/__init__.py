"""Utilities shared by the engine's layers."""
