#!/bin/sh
# Build the native IO runtime shared library: sh build.sh [output path].
set -e
cd "$(dirname "$0")"
out="${1:-libgfslam_io.so}"
g++ -O3 -fPIC -shared -std=c++17 \
    io_runtime.cpp -o "$out" -lpng -lz -lpthread
echo "built $out"
