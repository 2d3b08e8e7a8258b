"""Learning-rate schedules."""
