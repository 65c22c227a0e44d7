"""Offline training of the serving selectors' artifacts
(``selection_train``)."""
