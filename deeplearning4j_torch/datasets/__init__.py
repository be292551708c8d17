"""Dataset utilities the serving tier shares."""
