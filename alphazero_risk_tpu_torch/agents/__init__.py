"""Scripted opponent and the lockstep match helpers."""
