"""Actor loop, checkpoint loading and the evaluation trainer."""
