"""Staging of training inputs ahead of the step that reads them."""
