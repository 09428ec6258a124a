"""The gallery and the serving step on one device."""
