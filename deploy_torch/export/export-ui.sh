#!/bin/sh
# Port-forward the dashboard to localhost:8080.
kubectl -n foremast port-forward svc/foremast-ui 8080:8080
