#!/usr/bin/env bash
# Build the reference Columba (biointec/columba, mounted at /root/reference)
# OFFLINE for baseline measurement and golden-output parity testing.
#
# The stock build needs network (FetchContent: libsais, parallel-hashmap,
# fmtlib; git submodules: libdivsufsort, Big-BWT). This script patches a
# writable copy to:
#   - back the libsais/divsufsort API with our own SA-IS
#     (columba_jax/native/sais.cpp),
#   - replace parallel-hashmap with std::unordered_map/std::map shims,
#   - use the fmt headers bundled with the torch wheel (header-only).
#
# Outputs: /tmp/colbuild/columba and /tmp/colbuild/columba_build.
set -euo pipefail

REF=${REF:-/root/reference}
WORK=${WORK:-/tmp/colref}
BUILD=${BUILD:-/tmp/colbuild}
REPO=$(cd "$(dirname "$0")/.." && pwd)
FMT_DIR=/opt/venv/lib/python3.12/site-packages/torch/include

if [[ -x "$BUILD/columba" && -x "$BUILD/columba_build" ]]; then
    echo "reference already built at $BUILD"
    exit 0
fi

rm -rf "$WORK"
cp -r "$REF" "$WORK"
mkdir -p "$WORK/shim/parallel_hashmap"

cat > "$WORK/shim/libsais.h" <<'EOF'
#pragma once
#include <stdint.h>
#ifdef __cplusplus
extern "C" {
#endif
int32_t libsais(const uint8_t* T, int32_t* SA, int32_t n, int32_t fs, int32_t* freq);
#ifdef __cplusplus
}
#endif
EOF

cat > "$WORK/shim/libsais64.h" <<'EOF'
#pragma once
#include <stdint.h>
#ifdef __cplusplus
extern "C" {
#endif
int64_t libsais64(const uint8_t* T, int64_t* SA, int64_t n, int64_t fs, int64_t* freq);
#ifdef __cplusplus
}
#endif
EOF

cat > "$WORK/shim/divsufsort64.h" <<'EOF'
#pragma once
#include <stdint.h>
typedef int64_t saint_t;
#ifdef __cplusplus
extern "C" {
#endif
saint_t divsufsort64(const uint8_t* T, int64_t* SA, int64_t n);
#ifdef __cplusplus
}
#endif
EOF

cat > "$WORK/shim/sais_shim.cpp" <<'EOF'
#include <cstdint>
#include <vector>
#include "libsais.h"
#include "libsais64.h"
#include "divsufsort64.h"
extern "C" int sais_u8(const uint8_t* text, int64_t n, int64_t* sa);
extern "C" int32_t libsais(const uint8_t* T, int32_t* SA, int32_t n,
                           int32_t fs, int32_t* freq) {
    (void)fs; (void)freq;
    std::vector<int64_t> sa(n);
    if (sais_u8(T, n, sa.data()) != 0) return -1;
    for (int32_t i = 0; i < n; ++i) SA[i] = (int32_t)sa[i];
    return 0;
}
extern "C" int64_t libsais64(const uint8_t* T, int64_t* SA, int64_t n,
                             int64_t fs, int64_t* freq) {
    (void)fs; (void)freq;
    return sais_u8(T, n, SA) == 0 ? 0 : -1;
}
extern "C" saint_t divsufsort64(const uint8_t* T, int64_t* SA, int64_t n) {
    return sais_u8(T, n, SA) == 0 ? 0 : -1;
}
EOF

cp "$REPO/columba_jax/native/sais.cpp" "$WORK/shim/"

cat > "$WORK/shim/parallel_hashmap/phmap.h" <<'EOF'
#pragma once
#include <unordered_map>
namespace phmap {
template <class K, class V, class Hash = std::hash<K>, class Eq = std::equal_to<K>>
using parallel_flat_hash_map = std::unordered_map<K, V, Hash, Eq>;
template <class K, class V, class Hash = std::hash<K>, class Eq = std::equal_to<K>>
using flat_hash_map = std::unordered_map<K, V, Hash, Eq>;
}
EOF

cat > "$WORK/shim/parallel_hashmap/btree.h" <<'EOF'
#pragma once
#include <map>
namespace phmap {
template <class K, class V, class Cmp = std::less<K>>
using btree_map = std::map<K, V, Cmp>;
}
EOF

python3 - "$WORK" "$FMT_DIR" <<'EOF'
import re, sys
work, fmt_dir = sys.argv[1], sys.argv[2]
path = f"{work}/CMakeLists.txt"
s = open(path).read()
s = s.replace(
    'if(NOT GIT_SUBMOD_RESULT EQUAL "0")\n'
    '    message(FATAL_ERROR "Failed to initialize git submodules. '
    'Please run \'git submodule update --init --recursive\' manually.")\n'
    'endif()',
    '# submodule init skipped (offline build)')
s = re.sub(
    r"# Set specific build options for libsais.*?target_link_libraries\(columba_build libsais\)",
    "add_library(libsais_shim STATIC shim/sais_shim.cpp shim/sais.cpp)\n"
    "    target_include_directories(columba_build PRIVATE shim)\n"
    "    target_link_libraries(columba_build libsais_shim)",
    s, flags=re.S)
s = re.sub(
    r"FetchContent_Declare\(\s*parallel-hashmap.*?FetchContent_MakeAvailable\(parallel-hashmap\)",
    "# parallel-hashmap replaced by offline shim headers", s, flags=re.S)
s = re.sub(
    r"FetchContent_Declare\(\s*fmtlib.*?FetchContent_MakeAvailable\(fmtlib\)",
    f"include_directories({fmt_dir})\nadd_compile_definitions(FMT_HEADER_ONLY=1)",
    s, flags=re.S)
s = re.sub(r"target_link_libraries\((\w+) fmt::fmt\)", r"# \1: header-only fmt", s)
s = s.replace("fmt::fmt", "")
s = s.replace("include(FetchContent)",
              "include(FetchContent)\ninclude_directories(${CMAKE_SOURCE_DIR}/shim)")
open(path, "w").write(s)
EOF

mkdir -p "$BUILD"
cd "$BUILD"
cmake "$WORK" -DCMAKE_BUILD_TYPE=Release > cmake.log 2>&1
make -j"$(nproc)" > make.log 2>&1
echo "built: $BUILD/columba $BUILD/columba_build"
