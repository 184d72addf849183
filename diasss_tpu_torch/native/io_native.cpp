// Native survey-data loader (C2).
//
// The reference loads OpenCV FileStorage XML matrices through cv::FileStorage
// (the reference's src/util/util.cpp:86-128).  Multi-megabyte waterfall images
// parsed with Python's ElementTree dominate cold-start time; this loader scans
// the XML with a single pass over a memory buffer and converts numbers with
// strtod/strtol directly into a caller-provided array.
//
// C ABI (consumed via ctypes from diasss_tpu.native):
//   probe_cv_matrix(path, key, &rows, &cols, &dt) -> 0 on success
//   read_cv_matrix(path, key, out, capacity)      -> elements written, < 0 on error
//   read_txt_column(path, out, capacity)          -> values read, < 0 on error

#include <cctype>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

// Read a whole file into a string; returns false on failure.
bool slurp(const char* path, std::string& out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    long n = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    out.resize(static_cast<size_t>(n));
    size_t got = std::fread(&out[0], 1, static_cast<size_t>(n), f);
    std::fclose(f);
    return got == static_cast<size_t>(n);
}

// Locate the payload of <key ...> ... </key>; returns [begin, end) or false.
bool find_node(const std::string& xml, const char* key, size_t& begin, size_t& end) {
    std::string open = "<" + std::string(key);
    std::string close = "</" + std::string(key) + ">";
    size_t b = xml.find(open);
    if (b == std::string::npos) return false;
    b = xml.find('>', b);
    if (b == std::string::npos) return false;
    size_t e = xml.find(close, b);
    if (e == std::string::npos) return false;
    begin = b + 1;
    end = e;
    return true;
}

// Extract the integer content of <tag>N</tag> inside [begin, end).
long tag_int(const std::string& xml, size_t begin, size_t end, const char* tag) {
    std::string open = "<" + std::string(tag) + ">";
    size_t b = xml.find(open, begin);
    if (b == std::string::npos || b >= end) return -1;
    return std::strtol(xml.c_str() + b + open.size(), nullptr, 10);
}

char tag_dt(const std::string& xml, size_t begin, size_t end) {
    size_t b = xml.find("<dt>", begin);
    if (b == std::string::npos || b >= end) return '?';
    b += 4;
    while (b < end && std::isspace(static_cast<unsigned char>(xml[b]))) ++b;
    return xml[b];
}

}  // namespace

extern "C" {

int probe_cv_matrix(const char* path, const char* key, long* rows, long* cols, char* dt) {
    std::string xml;
    if (!slurp(path, xml)) return -1;
    size_t b, e;
    if (!find_node(xml, key, b, e)) return -2;
    *rows = tag_int(xml, b, e, "rows");
    *cols = tag_int(xml, b, e, "cols");
    *dt = tag_dt(xml, b, e);
    if (*rows < 0 || *cols < 0 || *dt == '?') return -3;
    return 0;
}

long read_cv_matrix(const char* path, const char* key, double* out, long capacity) {
    std::string xml;
    if (!slurp(path, xml)) return -1;
    size_t b, e;
    if (!find_node(xml, key, b, e)) return -2;
    size_t d = xml.find("<data>", b);
    if (d == std::string::npos || d >= e) return -3;
    const char* p = xml.c_str() + d + 6;
    const char* stop = xml.c_str() + e;
    long n = 0;
    while (p < stop && n < capacity) {
        char* next = nullptr;
        double v = std::strtod(p, &next);
        if (next == p) {
            // skip non-numeric char (tags, whitespace)
            if (*p == '<') break;  // reached </data>
            ++p;
            continue;
        }
        out[n++] = v;
        p = next;
    }
    return n;
}

long read_txt_column(const char* path, double* out, long capacity) {
    std::string body;
    if (!slurp(path, body)) return -1;
    const char* p = body.c_str();
    const char* stop = p + body.size();
    long n = 0;
    while (p < stop && n < capacity) {
        char* next = nullptr;
        double v = std::strtod(p, &next);
        if (next == p) break;  // no further number in the file
        out[n++] = v;
        p = next;
        // keep only the first token per line (reference util.cpp:139-150)
        while (p < stop && *p != '\n') ++p;
        if (p < stop) ++p;
    }
    return n;
}

}  // extern "C"
