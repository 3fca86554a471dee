"""Fitted-model state kept between ticks: the bounded fit cache."""
